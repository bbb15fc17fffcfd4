"""Frame renderer on the Pallas path: kernel transport + XLA environment fetch.

Same public contract as tpt.reference.render_frame, so callers (CLI,
progressive loop, benchmarks) switch backends freely.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..camera import camera_matrices
from ..config import CameraConfig, RenderConfig
from ..integrator import apply_environment, apply_environment_blocked
from ..progressive import AccumulatorState
from ..scene import Scene
from .trace import pallas_trace


@partial(jax.jit, static_argnames=("width", "height", "ray_depth", "spp",
                                   "counts", "jitter"))
def render_fields(scene: Scene, env_faces, inv_proj, inv_view, view_pos, frame,
                  focal_length, aperture_diameter,
                  *, width: int, height: int, ray_depth: int, spp: int,
                  counts: Tuple[int, int] | None = None,
                  jitter: str = "corner") -> Tuple[jax.Array, jax.Array]:
    """One frame's mean radiance via the Pallas kernel.
    Returns (image f32[H, W, 3], rays i32).

    ``counts``: optional static (n_spheres, n_cuboids) — specializes the
    compiled kernel to the scene's primitive counts (constant trip counts
    for the closest-hit loops)."""
    del view_pos  # the kernel derives it from inv_view's translation column
    res = pallas_trace(scene, inv_proj, inv_view, frame,
                       focal_length, aperture_diameter,
                       width=width, height=height, ray_depth=ray_depth,
                       spp=spp, counts=counts, jitter=jitter)
    mean = apply_environment(res, env_faces, spp)
    return jnp.moveaxis(mean, 0, -1), jnp.sum(res.ray_count)


def render_frame(scene: Scene, env_faces, camera: CameraConfig,
                 cfg: RenderConfig, frame: int) -> Tuple[jax.Array, jax.Array]:
    inv_proj, inv_view, pos = camera_matrices(camera, cfg.width, cfg.height)
    return render_fields(
        scene, env_faces, inv_proj, inv_view, pos, jnp.int32(frame),
        jnp.float32(camera.focal_length), jnp.float32(camera.aperture_diameter),
        width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
        spp=cfg.spp, counts=cfg.static_counts, jitter=cfg.jitter)


@partial(jax.jit, static_argnames=("width", "height", "ray_depth", "spp",
                                   "counts", "n_frames", "jitter", "refill"),
         donate_argnames=("accum",))
def progressive_frames(accum: AccumulatorState, scene: Scene, env_table,
                       inv_proj, inv_view, frame0, focal_length,
                       aperture_diameter,
                       *, width: int, height: int, ray_depth: int, spp: int,
                       counts: Tuple[int, int] | None = None,
                       n_frames: int = 1, n_valid=None,
                       jitter: str = "corner",
                       refill: bool | None = None
                       ) -> Tuple[AccumulatorState, jax.Array]:
    """Fold ``n_frames`` consecutive progressive frames into the accumulator
    in ONE device program.  The accumulator is donated (in-place update —
    the functional analogue of the reference's mutable RGBA32F accumulation
    texture, src/Render/PathTracer.cs:97-99).

    Two equivalent execution strategies:

    * ``refill=True`` (the default when n_frames > 1): ONE launch of the
      path-regeneration kernel (tpt.kernels.trace.pallas_trace_progressive)
      traces all frames — each lane drains its sample queue back-to-back,
      so Russian roulette's dead-lane tail is paid once per block of
      frames instead of once per frame (PERF.md).
      The env fetch then runs once per (frame, sample) slot — identical
      gather count — and the block folds in as one running-mean step
      ``acc' = (n0*acc + sum_f frame_f) / (n0 + F)``, algebraically equal
      to the per-frame mix (compute.glsl:128) with one division instead of
      F (the whole block is ulp-equivalent: same draws and decisions,
      last-ulp float rounding from the restructured program).
    * ``refill=False``: lax.scan over per-frame launches of
      the trace kernel + blocked env fetch + recursive running-mean mix.

    ``env_table``: pack_block_table(faces) output.
    ``n_valid``: optional traced i32 — frames ``k >= n_valid`` contribute
    nothing (no accumulation, no frame advance, no ray count).  Lets a
    caller render a partial tail chunk with the SAME compiled program
    instead of paying a second compile for the remainder size.
    Returns (new accumulator, total traced path segments i32).
    """
    if n_valid is None:
        n_valid = jnp.int32(n_frames)
    if refill is None:
        refill = n_frames > 1

    if refill:
        from ..env import sample_environment_blocked
        from .trace import pallas_trace_progressive
        res = pallas_trace_progressive(
            scene, inv_proj, inv_view, frame0, focal_length,
            aperture_diameter, width=width, height=height,
            ray_depth=ray_depth, spp=spp, n_frames=n_frames,
            n_valid=n_valid, counts=counts, jitter=jitter)
        total = res.rad_sum
        for k in range(n_frames * spp):
            envc = sample_environment_blocked(env_table, res.miss_dir[k])
            total = total + res.miss_thr[k] * envc
        total = jnp.moveaxis(total, 0, -1) / np.float32(spp)
        n0 = accum.frame.astype(jnp.float32)
        f = n_valid.astype(jnp.float32)
        image = (accum.image * n0 + total) / jnp.maximum(n0 + f, 1.0)
        return (AccumulatorState(image=image, frame=accum.frame + n_valid),
                jnp.sum(res.ray_count))

    def one_frame(acc: AccumulatorState, k):
        res = pallas_trace(scene, inv_proj, inv_view, frame0 + k,
                           focal_length, aperture_diameter,
                           width=width, height=height, ray_depth=ray_depth,
                           spp=spp, counts=counts, jitter=jitter)
        mean = jnp.moveaxis(apply_environment_blocked(res, env_table, spp),
                            0, -1)
        live = k < n_valid
        w = jnp.where(live,
                      1.0 / (acc.frame.astype(jnp.float32) + 1.0), 0.0)
        image = acc.image + (mean - acc.image) * w
        return (AccumulatorState(image=image,
                                 frame=acc.frame + live.astype(jnp.int32)),
                jnp.where(live, jnp.sum(res.ray_count), 0))

    accum, rays = jax.lax.scan(one_frame, accum,
                               jnp.arange(n_frames, dtype=jnp.int32))
    return accum, jnp.sum(rays)
