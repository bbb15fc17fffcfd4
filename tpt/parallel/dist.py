"""Multi-chip sharded rendering and inverse-rendering training.

The reference is strictly single-GPU (SURVEY.md §2.3) — this module is the
from-scratch scaling story over a mesh of cards:

  * mesh axes ``('dp', 'sp')``: ``dp`` shards *pixel rows* (image data
    parallelism — the natural axis of a path tracer: every pixel is
    independent), ``sp`` shards the *sample* axis (the honest
    sequence-parallel analogue: independent Monte-Carlo estimates of the
    same pixels, combined with a psum-mean).  TP/PP/EP have no analogue in
    a path tracer — there is no parameter matmul to split.
  * scene and camera parameters are replicated; the per-shard image block
    stays resident on its device; the only cross-device traffic is the
    O(H*W/dp) psum over ``sp`` and, in training, the O(|params|) gradient
    psum — both inserted by shard_map/autodiff, carried by NCCL.
  * ``sp`` sharding redefines the estimator (each sample shard draws an
    independent RNG stream via an offset frame index) — equally unbiased,
    but not bit-identical to the sequential-spp reference stream.  ``dp``
    sharding is bit-exact: seeds depend only on absolute pixel coords.
  * the cards of one host are joined all to all, so the mesh shape follows
    the algorithm alone; several hosts join through
    tpt.parallel.init.init_distributed before the mesh is built.

Gradient notes: jax.grad flows through the whole renderer — bilinear env
weights, Beer exponents, Fresnel, intersection distances, thin-lens optics.
Discrete decisions (lobe pick, RR survival, closest-hit winner) are
piecewise-constant (jnp.where), so their gradients are the standard
detached-decision estimator of differentiable path tracing: exact for the
continuous factors, biased at decision boundaries.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

# constant loop-carry inits inside the integrator are unvarying w.r.t. the
# mesh; disable the varying-manual-axes check rather than pcast every init
shard_map = functools.partial(jax.shard_map, check_vma=False)

from ..config import RenderConfig
from ..env import pack_block_table
from ..integrator import (apply_environment, apply_environment_blocked,
                          camera_params, compose_trace_fn,
                          make_scene_scan_fn, make_xla_gather_fn, trace_paths)
from ..scene import Scene


def make_mesh(dp: Optional[int] = None, sp: int = 1, devices=None) -> Mesh:
    """Build a ('dp', 'sp') mesh. Defaults: all devices on dp."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    return Mesh(devices.reshape(dp, sp), ("dp", "sp"))


def _pad_rows(height: int, dp: int) -> int:
    return -(-height // dp) * dp


def make_dist_renderer(mesh: Mesh, cfg: RenderConfig, n_sample_groups: int = None,
                       backend: str = "kernel"):
    """Sharded frame renderer.

    Returns jit(fn)(scene, env_faces, inv_proj, inv_view, focal, aperture,
    frame) -> (image f32[H, W, 3] sharded over rows, rays i32).

    ``n_sample_groups`` independent sample groups run over the 'sp' axis
    (default: the axis size); each group renders cfg.spp samples with its
    own RNG stream, psum-meaned at the end.

    ``backend``: 'kernel' (production — the Pallas trace kernel runs on each
    device's row band, env fetched via the one-row-gather block table) or
    'oracle' (the XLA integrator; the test reference).  Both are bit-exact
    to a whole-frame single-chip render under pure dp sharding, because
    seeds depend only on absolute pixel coords.
    """
    if backend not in ("kernel", "oracle"):
        raise ValueError(f"unknown backend {backend!r}")
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    groups = n_sample_groups or sp
    if groups % sp:
        raise ValueError(f"n_sample_groups {groups} must divide over sp={sp}")
    groups_per_shard = groups // sp
    hpad = _pad_rows(cfg.height, dp)
    rows_local = hpad // dp
    width, height, ray_depth, spp = cfg.width, cfg.height, cfg.ray_depth, cfg.spp
    counts = cfg.static_counts
    jitter = cfg.jitter

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P("dp", None, None), P()),
    )
    def render_block(scene, env, inv_proj, inv_view, focal, aperture, frame):
        dp_idx = jax.lax.axis_index("dp")
        sp_idx = jax.lax.axis_index("sp")
        y0 = dp_idx * rows_local

        acc = jnp.zeros((3, rows_local, width), jnp.float32)
        rays = jnp.int32(0)
        for g in range(groups_per_shard):
            group_id = sp_idx * groups_per_shard + g
            frame_eff = frame * groups + group_id
            if backend == "kernel":
                from ..kernels.trace import pallas_trace
                res = pallas_trace(scene, inv_proj, inv_view, frame_eff,
                                   focal, aperture, width=width, height=height,
                                   ray_depth=ray_depth, spp=spp, counts=counts,
                                   n_rows=rows_local, row0=y0, jitter=jitter)
                acc = acc + apply_environment_blocked(res, env, spp)
            else:
                py = y0 + jax.lax.broadcasted_iota(
                    jnp.int32, (rows_local, width), 0)
                py = jnp.minimum(py, height - 1)  # pad rows redo the last row
                px = jax.lax.broadcasted_iota(jnp.int32, (rows_local, width), 1)
                scan = make_scene_scan_fn(scene, counts=counts)
                gather = make_xla_gather_fn(scene)
                cam = camera_params(inv_proj, inv_view, focal, aperture)
                res = trace_paths(compose_trace_fn(scan, gather), cam, px, py,
                                  width, height, frame_eff, ray_depth, spp,
                                  jitter=jitter)
                acc = acc + apply_environment(res, env, spp)
            rays = rays + jnp.sum(res.ray_count)

        acc = jax.lax.psum(acc, "sp") / np.float32(groups)
        rays = jax.lax.psum(rays, "sp")
        rays = jax.lax.psum(rays, "dp")
        return jnp.moveaxis(acc, 0, -1), rays

    @jax.jit
    def render(scene, env_faces, inv_proj, inv_view, focal, aperture, frame):
        env = pack_block_table(env_faces) if backend == "kernel" else env_faces
        image, rays = render_block(scene, env, inv_proj, inv_view,
                                   jnp.float32(focal), jnp.float32(aperture),
                                   jnp.int32(frame))
        return image[:height], rays

    return render


def make_dist_progressive(mesh: Mesh, cfg: RenderConfig, n_frames: int):
    """Sharded PROGRESSIVE block renderer — the multi-chip twin of
    kernels.render.progressive_frames(refill=True).

    Each device folds a block of frames into its pixel-row band in ONE
    program: the path-regeneration kernel traces its band's sample queues
    (row0/n_rows mode), the blocked env gather runs per (frame, sample)
    slot, and the band accumulator updates in place (donated).  The 'sp'
    axis shards the BLOCK's frames: shard s renders the contiguous
    sub-block [frame0 + s*F/sp, ...) and the per-pixel frame sums meet in
    one psum-mean — identical estimator to the single-chip block (seeds
    depend only on absolute pixel coords and frame indices), differing
    only in psum summation order (ulp).

    Returns jit(fn)(accum, scene, env_table, inv_proj, inv_view, focal,
    aperture, frame0) -> (accum', rays) with ``accum`` donated.
    ``n_frames`` must divide by sp.
    """
    from ..kernels.trace import pallas_trace_progressive
    from ..progressive import AccumulatorState

    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    if n_frames % sp:
        raise ValueError(f"n_frames {n_frames} must divide by sp={sp}")
    f_loc = n_frames // sp
    hpad = _pad_rows(cfg.height, dp)
    rows_local = hpad // dp
    width, height, ray_depth, spp = cfg.width, cfg.height, cfg.ray_depth, cfg.spp
    counts = cfg.static_counts
    jitter = cfg.jitter

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("dp", None, None), P(), P(), P(), P(), P(), P(), P(),
                  P()),
        out_specs=(P("dp", None, None), P()),
    )
    def block(acc_band, scene, env_table, inv_proj, inv_view, focal,
              aperture, frame0, n0):
        from ..env import sample_environment_blocked
        dp_idx = jax.lax.axis_index("dp")
        sp_idx = jax.lax.axis_index("sp")
        y0 = dp_idx * rows_local
        res = pallas_trace_progressive(
            scene, inv_proj, inv_view, frame0 + sp_idx * f_loc, focal,
            aperture, width=width, height=height, ray_depth=ray_depth,
            spp=spp, n_frames=f_loc, counts=counts, n_rows=rows_local,
            row0=y0, jitter=jitter)
        total = res.rad_sum
        for k in range(f_loc * spp):
            envc = sample_environment_blocked(env_table, res.miss_dir[k])
            total = total + res.miss_thr[k] * envc
        total = jax.lax.psum(total, "sp")
        image = jnp.moveaxis(total, 0, -1) / np.float32(spp)
        nf = np.float32(n_frames)
        acc_band = (acc_band * n0 + image) / (n0 + nf)
        rays = jax.lax.psum(jnp.sum(res.ray_count), ("dp", "sp"))
        return acc_band, rays

    @functools.partial(jax.jit, donate_argnames=("accum",))
    def render_block(accum: AccumulatorState, scene, env_table, inv_proj,
                     inv_view, focal, aperture, frame0):
        pad = hpad - height
        img = jnp.pad(accum.image, ((0, pad), (0, 0), (0, 0)))
        n0 = accum.frame.astype(jnp.float32)
        img, rays = block(img, scene, env_table, inv_proj, inv_view,
                          jnp.float32(focal), jnp.float32(aperture),
                          jnp.int32(frame0), n0)
        return (AccumulatorState(image=img[:height],
                                 frame=accum.frame + n_frames), rays)

    return render_block


def trainable_filter_grads(grads: Scene) -> Scene:
    """Zero gradients for non-optimizable scene leaves (counts, geometry
    pads): inverse rendering here optimizes the material tables."""
    return Scene(
        sphere_pos_radius=jnp.zeros_like(grads.sphere_pos_radius),
        sphere_material=grads.sphere_material,
        cuboid_min=jnp.zeros_like(grads.cuboid_min),
        cuboid_max=jnp.zeros_like(grads.cuboid_max),
        cuboid_material=grads.cuboid_material,
        num_spheres=jnp.int32(0),
        num_cuboids=jnp.int32(0),
    )


def make_train_step(mesh: Mesh, cfg: RenderConfig, n_sample_groups: int = None,
                    counts: Tuple[int, int] = None, param_mask=None,
                    backend: str = "kernel", russian_roulette: bool = True,
                    optimizer=None, psum_bands: int = 1):
    """Inverse-rendering step: pixel-MSE against a target image, gradient
    descent on the material tables (BASELINE.json config 5).

    With ``optimizer=None`` (bare SGD):
    returns jit(fn)(scene, env_faces, inv_proj, inv_view, focal, aperture,
    frame, target f32[H,W,3], lr) -> (new_scene, loss).

    With ``optimizer`` an optax GradientTransformation (e.g.
    tpt.optim.clipped_adam()): the step takes ``opt_state`` instead of
    ``lr`` and returns (new_scene, new_opt_state, loss); initialize with
    ``optimizer.init((scene.sphere_material, scene.cuboid_material))`` and
    checkpoint/resume via tpt.optim.save_optim_checkpoint.

    ``param_mask``: optional (sphere_mask, cuboid_mask) 0/1 arrays shaped
    like the material tables; entries with mask 0 stay frozen.

    ``backend``: 'kernel' = Pallas forward + XLA reverse-mode backward
    (tpt.kernels.trace_grad) per row band; 'oracle' = XLA integrator
    forward and backward (the test reference).

    The renderer runs sharded exactly as make_dist_renderer; autodiff
    transposes the psum-mean into broadcast and the replicated-scene reads
    into a cross-mesh gradient psum — the all-reduce the SURVEY's
    parallelism table calls for.

    ``psum_bands``: split each device's row band into this many sub-bands,
    each with its OWN gradient psum (see banded_grad_block below) so the
    collective for one band can overlap the next band's backward — the
    SURVEY §7(g) overlap.  1 = the classic single psum placed by autodiff
    after the whole backward.

    ``russian_roulette=False`` selects fixed-depth differentiable
    transport: RR'd pixel values depend only on albedo RATIOS (the RR
    weight divides by the max throughput channel), so albedo-scale
    recovery through an RR'd render is impossible for any pixel-loss
    estimator — see tpt.integrator.bounce_step.  Serious inverse-rendering
    runs should pass False (benchmarks/inverse_demo.py does).
    """
    if backend not in ("kernel", "oracle"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" and counts is None:
        # reverse mode needs static trip counts; the padded (256, 64)
        # fallback would differentiate ~6x wasted primitive tests
        raise ValueError("backend='kernel' requires explicit counts, e.g. "
                         "counts=(48, 7) for the demo scene")
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    groups = n_sample_groups or sp
    groups_per_shard = groups // sp
    hpad = _pad_rows(cfg.height, dp)
    rows_local = hpad // dp
    width, height, ray_depth, spp = cfg.width, cfg.height, cfg.ray_depth, cfg.spp
    jitter = cfg.jitter

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P("dp", None, None)),
        out_specs=P(),
    )
    def loss_block(scene, env, inv_proj, inv_view, focal, aperture,
                   frame, target_block):
        dp_idx = jax.lax.axis_index("dp")
        sp_idx = jax.lax.axis_index("sp")
        y0 = dp_idx * rows_local
        py = y0 + jax.lax.broadcasted_iota(jnp.int32, (rows_local, width), 0)
        valid = (py < height).astype(jnp.float32)
        py = jnp.minimum(py, height - 1)
        px = jax.lax.broadcasted_iota(jnp.int32, (rows_local, width), 1)

        # static counts: reverse-mode AD cannot transpose dynamic-trip loops
        if counts is None:
            import warnings
            warnings.warn(
                "make_train_step(backend='oracle') without counts reverse-"
                "differentiates the full 320-primitive padded scan (~6x "
                "wasted work); pass counts=(n_spheres, n_cuboids)",
                stacklevel=2)
        c = counts or (256, 64)
        acc = jnp.zeros((3, rows_local, width), jnp.float32)
        for g in range(groups_per_shard):
            group_id = sp_idx * groups_per_shard + g
            frame_eff = frame * groups + group_id
            if backend == "kernel":
                from ..kernels.trace_grad import trace_diff
                res = trace_diff(scene, inv_proj, inv_view, frame_eff,
                                 focal, aperture, y0, width, height,
                                 ray_depth, spp, c, rows_local, jitter,
                                 russian_roulette)
                acc = acc + apply_environment_blocked(res, env, spp)
            else:
                scan = make_scene_scan_fn(scene, counts=c)
                gather = make_xla_gather_fn(scene)
                cam = camera_params(inv_proj, inv_view, focal, aperture)
                res = trace_paths(compose_trace_fn(scan, gather), cam, px, py,
                                  width, height, frame_eff, ray_depth, spp,
                                  jitter=jitter,
                                  russian_roulette=russian_roulette)
                acc = acc + apply_environment(res, env, spp)
        acc = jax.lax.psum(acc, "sp") / np.float32(groups)

        image = jnp.moveaxis(acc, 0, -1)
        err = (image - target_block) * valid[..., None]
        sse = jax.lax.psum(jnp.sum(err * err), "dp")
        return sse / np.float32(height * width * 3)

    if rows_local % psum_bands:
        raise ValueError(f"psum_bands {psum_bands} must divide the local "
                         f"row band ({rows_local} rows at dp={dp})")
    rows_sub = rows_local // psum_bands

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P("dp", None, None)),
        out_specs=(P(), P(), P()),
    )
    def banded_grad_block(scene, env, inv_proj, inv_view, focal, aperture,
                          frame, target_block):
        """Per-device loss AND material-table gradients, with the gradient
        all-reduce split into ``psum_bands`` independent per-sub-band psums.

        The single-psum path (autodiff through the shard_map boundary) emits
        ONE parameter psum strictly after the whole backward; splitting the
        device's row band gives XLA ``psum_bands`` independent
        backward->psum chains, so the collective for sub-band b can run
        while sub-band b+1's backward computes — the overlap SURVEY §7(g)
        calls for.  The cotangent per band is the two material tables
        (48+7 rows x 16 floats ~ 3.5 KB) — latency-, not bandwidth-bound,
        which is when overlap pays across hosts.
        """
        dp_idx = jax.lax.axis_index("dp")
        sp_idx = jax.lax.axis_index("sp")
        c = counts or (256, 64)
        sm0, cm0 = scene.sphere_material, scene.cuboid_material

        total = jnp.float32(0.0)
        g_sm = jnp.zeros_like(sm0)
        g_cm = jnp.zeros_like(cm0)
        for b in range(psum_bands):
            y0b = dp_idx * rows_local + b * rows_sub
            target_sub = target_block[b * rows_sub:(b + 1) * rows_sub]
            py = y0b + jax.lax.broadcasted_iota(
                jnp.int32, (rows_sub, width), 0)
            valid = (py < height).astype(jnp.float32)

            def acc_fn(sm, cm, y0b=y0b, py=py):
                """This shard's sample-group radiance sum for sub-band b —
                the only part autodiff touches.  No collective inside: the
                MSE cotangent is handed to its vjp analytically below, so
                nothing ever transposes a psum (grad-through-psum under
                check_vma=False double-counts the sp axis)."""
                s = dataclasses.replace(scene, sphere_material=sm,
                                        cuboid_material=cm)
                acc = jnp.zeros((3, rows_sub, width), jnp.float32)
                for g in range(groups_per_shard):
                    group_id = sp_idx * groups_per_shard + g
                    frame_eff = frame * groups + group_id
                    if backend == "kernel":
                        from ..kernels.trace_grad import trace_diff
                        res = trace_diff(s, inv_proj, inv_view, frame_eff,
                                         focal, aperture, y0b, width, height,
                                         ray_depth, spp, c, rows_sub, jitter,
                                         russian_roulette)
                        acc = acc + apply_environment_blocked(res, env, spp)
                    else:
                        pyc = jnp.minimum(py, height - 1)
                        px = jax.lax.broadcasted_iota(
                            jnp.int32, (rows_sub, width), 1)
                        scan = make_scene_scan_fn(s, counts=c)
                        gather = make_xla_gather_fn(s)
                        cam = camera_params(inv_proj, inv_view, focal,
                                            aperture)
                        res = trace_paths(compose_trace_fn(scan, gather),
                                          cam, px, pyc, width, height,
                                          frame_eff, ray_depth, spp,
                                          jitter=jitter,
                                          russian_roulette=russian_roulette)
                        acc = acc + apply_environment(res, env, spp)
                return acc

            acc_local, vjp_fn = jax.vjp(acc_fn, sm0, cm0)
            image = jnp.moveaxis(
                jax.lax.psum(acc_local, "sp") / np.float32(groups), 0, -1)
            err = (image - target_sub) * valid[..., None]
            sse_b = jnp.sum(err * err)
            # d(sse)/d(acc_local) by hand: 2*err through the sp-mean
            ct = jnp.moveaxis(2.0 * err, -1, 0) / np.float32(groups)
            gs, gc = vjp_fn(ct)
            # THE banded all-reduce: one independent collective per band,
            # free to overlap band b+1's backward
            g_sm = g_sm + jax.lax.psum(gs, ("dp", "sp"))
            g_cm = g_cm + jax.lax.psum(gc, ("dp", "sp"))
            total = total + jax.lax.psum(sse_b, "dp")

        scale = np.float32(height * width * 3)
        # acc_fn vjps carry the raw SSE cotangent; the loss normalization
        # is a constant factor, applied once here
        return total / scale, g_sm / scale, g_cm / scale

    def loss_fn(params, scene, env_faces, inv_proj, inv_view, focal, aperture,
                frame, target):
        # differentiate w.r.t. the material tables only (float leaves)
        sphere_mat, cuboid_mat = params
        scene = dataclasses.replace(scene, sphere_material=sphere_mat,
                                    cuboid_material=cuboid_mat)
        pad = hpad - height
        target_pad = jnp.pad(target, ((0, pad), (0, 0), (0, 0)))
        env = (pack_block_table(env_faces) if backend == "kernel"
               else env_faces)
        return loss_block(scene, env, inv_proj, inv_view, focal,
                          aperture, frame, target_pad)

    def _grads(scene, env_faces, inv_proj, inv_view, focal, aperture,
               frame, target):
        if psum_bands > 1:
            pad = hpad - height
            target_pad = jnp.pad(target, ((0, pad), (0, 0), (0, 0)))
            env = (pack_block_table(env_faces) if backend == "kernel"
                   else env_faces)
            loss, g_sphere, g_cuboid = banded_grad_block(
                scene, env, inv_proj, inv_view, jnp.float32(focal),
                jnp.float32(aperture), jnp.int32(frame), target_pad)
        else:
            params = (scene.sphere_material, scene.cuboid_material)
            loss, (g_sphere, g_cuboid) = jax.value_and_grad(loss_fn)(
                params, scene, env_faces, inv_proj, inv_view,
                jnp.float32(focal), jnp.float32(aperture), jnp.int32(frame),
                target)
        if param_mask is not None:
            g_sphere = g_sphere * param_mask[0]
            g_cuboid = g_cuboid * param_mask[1]
        return loss, g_sphere, g_cuboid

    if optimizer is None:
        @jax.jit
        def step(scene, env_faces, inv_proj, inv_view, focal, aperture,
                 frame, target, lr):
            loss, g_sphere, g_cuboid = _grads(
                scene, env_faces, inv_proj, inv_view, focal, aperture,
                frame, target)
            new_scene = dataclasses.replace(
                scene,
                sphere_material=scene.sphere_material - lr * g_sphere,
                cuboid_material=scene.cuboid_material - lr * g_cuboid,
            )
            return new_scene, loss

        return step

    import optax

    @jax.jit
    def opt_step(scene, env_faces, inv_proj, inv_view, focal, aperture,
                 frame, target, opt_state):
        loss, g_sphere, g_cuboid = _grads(
            scene, env_faces, inv_proj, inv_view, focal, aperture,
            frame, target)
        params = (scene.sphere_material, scene.cuboid_material)
        updates, opt_state = optimizer.update(
            (g_sphere, g_cuboid), opt_state, params)
        sphere_mat, cuboid_mat = optax.apply_updates(params, updates)
        new_scene = dataclasses.replace(
            scene, sphere_material=sphere_mat, cuboid_material=cuboid_mat)
        return new_scene, opt_state, loss

    return opt_step
