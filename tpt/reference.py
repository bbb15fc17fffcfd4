"""The oracle renderer: the whole integrator in plain XLA.

This is the framework's "CPU duplicate" in the sense of SURVEY.md §4 — an
independent-of-Pallas implementation of the full GLSL algorithm used to
verify the Pallas kernels (and usable as a renderer in its own right; it
jits to plain XLA code on any backend).

Two equivalent entry points:
  * :func:`render_fields` — batched over the [H, W] pixel grid directly;
  * :func:`render_fields_vmap` — a per-pixel scalar ``radiance()`` vmapped
    over pixels (BASELINE.json config 1 wording). Identical results.

Image convention: row 0 is the *bottom* of the image (GL pixel layout, as in
the reference's accumulation texture). Flip on export.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .camera import camera_matrices
from .config import CameraConfig, RenderConfig
from .integrator import (apply_environment, camera_params, compose_trace_fn,
                         make_scene_scan_fn, make_xla_gather_fn, trace_paths)
from .progressive import AccumulatorState, accumulate
from .scene import Scene


def _pixel_grid(height: int, width: int):
    py = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)  # row = GL y
    px = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)  # col = x
    return px, py


@partial(jax.jit, static_argnames=("width", "height", "ray_depth", "spp",
                                   "jitter"))
def render_fields(scene: Scene, env_faces, inv_proj, inv_view, view_pos, frame,
                  focal_length, aperture_diameter,
                  *, width: int, height: int, ray_depth: int, spp: int,
                  jitter: str = "corner") -> Tuple[jax.Array, jax.Array]:
    """One frame's mean radiance. Returns (image f32[H, W, 3], rays i32)."""
    del view_pos  # == inv_view translation column
    px, py = _pixel_grid(height, width)
    scan = make_scene_scan_fn(scene)
    gather = make_xla_gather_fn(scene)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)
    res = trace_paths(compose_trace_fn(scan, gather), cam, px, py, width,
                      height, frame, ray_depth, spp, jitter=jitter)
    mean = apply_environment(res, env_faces, spp)
    return jnp.moveaxis(mean, 0, -1), jnp.sum(res.ray_count)


@partial(jax.jit, static_argnames=("width", "height", "ray_depth", "spp"))
def render_fields_vmap(scene: Scene, env_faces, inv_proj, inv_view, view_pos, frame,
                       focal_length, aperture_diameter,
                       *, width: int, height: int, ray_depth: int, spp: int
                       ) -> Tuple[jax.Array, jax.Array]:
    """Scalar per-pixel integrator vmapped over the flattened pixel grid."""
    del view_pos
    px, py = _pixel_grid(height, width)
    scan = make_scene_scan_fn(scene)
    gather = make_xla_gather_fn(scene)
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)

    def one_pixel(x, y):
        res = trace_paths(compose_trace_fn(scan, gather), cam, x, y, width,
                          height, frame, ray_depth, spp)
        mean = apply_environment(res, env_faces, spp)
        return mean, res.ray_count

    mean, rays = jax.vmap(jax.vmap(one_pixel))(px, py)
    return mean, jnp.sum(rays)


def render_frame(scene: Scene, env_faces, camera: CameraConfig,
                 cfg: RenderConfig, frame: int) -> Tuple[jax.Array, jax.Array]:
    """Convenience wrapper building camera matrices from a CameraConfig."""
    inv_proj, inv_view, pos = camera_matrices(camera, cfg.width, cfg.height)
    return render_fields(
        scene, env_faces, inv_proj, inv_view, pos, jnp.int32(frame),
        jnp.float32(camera.focal_length), jnp.float32(camera.aperture_diameter),
        width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
        spp=cfg.spp, jitter=cfg.jitter)


def render_progressive(scene: Scene, env_faces, camera: CameraConfig,
                       cfg: RenderConfig, state: AccumulatorState,
                       num_frames: int) -> Tuple[AccumulatorState, int]:
    """Accumulate ``num_frames`` progressive frames. Returns (state, rays)."""
    total_rays = 0
    for _ in range(num_frames):
        image, rays = render_frame(scene, env_faces, camera, cfg, int(state.frame))
        state = accumulate(state, image)
        total_rays += int(rays)
    return state, total_rays
