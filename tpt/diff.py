"""Differentiable rendering: fast Pallas forward + oracle-replay backward.

The Pallas kernel and the XLA oracle compute the *same function* (shared
integrator source; see tests/test_kernel.py), so a
custom_vjp pairing the kernel's forward with reverse-mode AD through the
oracle is mathematically consistent: you get kernel-speed primals and exact
oracle gradients.  The backward replays the trace with per-bounce
rematerialization (jax.checkpoint), storing only inter-bounce carries.

Differentiable inputs: the whole material tables, sphere positions/radii,
cuboid bounds, the environment cubemap, and the thin-lens focal length /
aperture diameter (BASELINE.json north star).  Discrete decisions (lobe
choice, RR survival, scan winner) are treated as detached — the standard
differentiable-path-tracing estimator; see tpt.parallel.dist docstring.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .config import MAX_CUBOIDS, MAX_SPHERES
from .integrator import (apply_environment, camera_params, compose_trace_fn,
                         make_scene_scan_fn, make_xla_gather_fn, trace_paths)
from .scene import Scene


class DiffInputs(NamedTuple):
    """The differentiable leaves of a render."""
    sphere_pos_radius: jax.Array
    sphere_material: jax.Array
    cuboid_min: jax.Array
    cuboid_max: jax.Array
    cuboid_material: jax.Array
    env_faces: jax.Array
    focal_length: jax.Array
    aperture_diameter: jax.Array

    @staticmethod
    def from_scene(scene: Scene, env_faces, focal_length, aperture_diameter
                   ) -> "DiffInputs":
        return DiffInputs(scene.sphere_pos_radius, scene.sphere_material,
                          scene.cuboid_min, scene.cuboid_max,
                          scene.cuboid_material, jnp.asarray(env_faces),
                          jnp.asarray(focal_length, jnp.float32),
                          jnp.asarray(aperture_diameter, jnp.float32))


def _oracle_image(diff: DiffInputs, inv_proj, inv_view, frame,
                  width, height, ray_depth, spp, counts, rr=True):
    scene = Scene(sphere_pos_radius=diff.sphere_pos_radius,
                  sphere_material=diff.sphere_material,
                  cuboid_min=diff.cuboid_min, cuboid_max=diff.cuboid_max,
                  cuboid_material=diff.cuboid_material,
                  num_spheres=jnp.int32(counts[0]),
                  num_cuboids=jnp.int32(counts[1]))
    py = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    px = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    scan = make_scene_scan_fn(scene, counts=counts)
    gather = make_xla_gather_fn(scene)
    cam = camera_params(inv_proj, inv_view, diff.focal_length,
                        diff.aperture_diameter)
    res = trace_paths(compose_trace_fn(scan, gather), cam, px, py,
                      width, height, frame, ray_depth, spp, loop="remat",
                      russian_roulette=rr)
    mean = apply_environment(res, diff.env_faces, spp)
    return jnp.moveaxis(mean, 0, -1)


def _kernel_image(diff: DiffInputs, inv_proj, inv_view, frame,
                  width, height, ray_depth, spp, counts, rr=True):
    from .kernels.trace import pallas_trace
    scene = Scene(sphere_pos_radius=diff.sphere_pos_radius,
                  sphere_material=diff.sphere_material,
                  cuboid_min=diff.cuboid_min, cuboid_max=diff.cuboid_max,
                  cuboid_material=diff.cuboid_material,
                  num_spheres=jnp.int32(counts[0]),
                  num_cuboids=jnp.int32(counts[1]))
    res = pallas_trace(scene, inv_proj, inv_view, frame, diff.focal_length,
                       diff.aperture_diameter, width=width, height=height,
                       ray_depth=ray_depth, spp=spp, rr=rr)
    mean = apply_environment(res, diff.env_faces, spp)
    return jnp.moveaxis(mean, 0, -1)


@partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9))
def render_diff(diff: DiffInputs, inv_proj, inv_view, frame,
                width: int, height: int, ray_depth: int, spp: int,
                counts: Tuple[int, int], rr: bool = True):
    """Differentiable frame render: f32[H, W, 3] mean radiance.

    Primal via the Pallas kernel; cotangents via oracle replay.
    ``counts`` must be static (n_spheres, n_cuboids).  ``rr=False``
    selects fixed-depth transport — required for albedo-scale recovery
    (see tpt.integrator.bounce_step)."""
    return _kernel_image(diff, inv_proj, inv_view, frame,
                         width, height, ray_depth, spp, counts, rr)


def _render_diff_fwd(diff, inv_proj, inv_view, frame,
                     width, height, ray_depth, spp, counts, rr=True):
    out = _kernel_image(diff, inv_proj, inv_view, frame,
                        width, height, ray_depth, spp, counts, rr)
    return out, (diff, inv_proj, inv_view, frame)


def _render_diff_bwd(width, height, ray_depth, spp, counts, rr, residuals, g):
    diff, inv_proj, inv_view, frame = residuals
    _, vjp = jax.vjp(
        lambda d, ip, iv: _oracle_image(d, ip, iv, frame, width, height,
                                        ray_depth, spp, counts, rr),
        diff, inv_proj, inv_view)
    d_diff, d_ip, d_iv = vjp(g)
    return d_diff, d_ip, d_iv, None


render_diff.defvjp(_render_diff_fwd, _render_diff_bwd)


def render_scene_diff(scene: Scene, env_faces, inv_proj, inv_view, frame,
                      focal_length, aperture_diameter, *,
                      width: int, height: int, ray_depth: int, spp: int,
                      counts: Tuple[int, int]):
    """Convenience wrapper taking a Scene pytree."""
    diff = DiffInputs.from_scene(scene, env_faces, focal_length, aperture_diameter)
    return render_diff(diff, inv_proj, inv_view, jnp.int32(frame),
                       width, height, ray_depth, spp, counts)
