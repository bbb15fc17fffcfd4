"""Pallas GPU path-tracing kernels (Triton route).

The production counterpart of the GLSL compute kernel
(res/shaders/PathTracing/compute.glsl:101-224), which runs one thread per
pixel with the scene in a uniform buffer and a per-thread ``break`` on path
death.  Here one Triton program traces a power-of-two block of pixels, and
each program runs the *shared* integrator (tpt.integrator — the same code
the XLA oracle executes) over its block:

  * per-lane path state (origin, direction, throughput, seed, ...) are
    ``f32[BLOCK]`` / ``u32[BLOCK]`` values that stay in registers across
    the whole bounce loop — the megakernel the shader is, with no
    round-trip of path state through device memory between bounces;
  * the bounce loop is one rolled ``while_loop`` that exits once every lane
    of the block is dead (tpt.integrator.trace_samples, ``loop="rolled"``);
  * the scene tables are ordinary device-memory inputs
    (f32[256, 4], [256, 16], [64, 8], [64, 16]): the closest-hit fold reads
    per-primitive scalars that every lane shares (the L1 / constant-cache
    analogue of the shader's uniform buffer), and the winner's attributes
    are per-lane gathers from the same tables;
  * the environment fetch is deferred to plain XLA outside the kernel
    (see tpt.integrator docstring: exact, since a sample misses at most once).

Because the kernel and the oracle share every line of transport math, their
outputs agree draw-for-draw; tests assert allclose at tight tolerance.

Where the kernels run is decided once, in tpt.kernels.device: compiled on
the GPU, interpreted only on request.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import MAX_CUBOIDS, MAX_SPHERES
from ..integrator import (MAT_LANES, CameraParams, ProgressiveTraceResult,
                          TraceResult, Winner, any_lane, compose_trace_fn,
                          init_progressive_state, make_scan_fn,
                          progressive_iteration, trace_samples)
from ..vecmath import Vec3, where3
from .device import use_interpreter

# Pixels per Triton program and its warps.  The block is a power of two
# (Triton's tensors must be); a smaller block ends its bounce loop sooner
# after Russian roulette kills most lanes, a larger one amortizes the
# per-program scene reads.  Chosen by measurement on the card (PERF.md).
BLOCK = 256
NUM_WARPS = 4

CAM_WORDS = 64      # 2 mat4 + focal + aperture = 34 floats, padded
INT_WORDS = 8       # frame, n_spheres, n_cuboids, row0, n_valid, pad


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def _pack_cam(inv_proj, inv_view, focal_length, aperture_diameter):
    cam = jnp.concatenate([
        jnp.asarray(inv_proj, jnp.float32).ravel(),
        jnp.asarray(inv_view, jnp.float32).ravel(),
        jnp.asarray(focal_length, jnp.float32).reshape(1),
        jnp.asarray(aperture_diameter, jnp.float32).reshape(1),
    ])
    return jnp.pad(cam, (0, CAM_WORDS - cam.shape[0]))


def _unpack_cam(cam_ref) -> CameraParams:
    """CameraParams from the packed camera vector (2 mat4 + 2 floats)."""
    iv = lambda r, c: cam_ref[16 + r * 4 + c]
    return CameraParams(
        ip00=cam_ref[0], ip01=cam_ref[1], ip02=cam_ref[2],
        ip10=cam_ref[4], ip11=cam_ref[5], ip12=cam_ref[6],
        right=(iv(0, 0), iv(1, 0), iv(2, 0)),
        up=(iv(0, 1), iv(1, 1), iv(2, 1)),
        backward=(iv(0, 2), iv(1, 2), iv(2, 2)),
        eye=(iv(0, 3), iv(1, 3), iv(2, 3)),
        focal_length=cam_ref[32],
        aperture_diameter=cam_ref[33],
    )


def _scene_tables(scene):
    """The scene as four power-of-two tables: sphere f32[256,4] and
    f32[256,16]; cuboid f32[64,8] as (min.xyz, pad, max.xyz, pad) — the
    std140 vec3 stride, incidentally — and f32[64,16]."""
    pad = jnp.zeros((MAX_CUBOIDS, 1), jnp.float32)
    cuboid_geom = jnp.concatenate(
        [scene.cuboid_min, pad, scene.cuboid_max, pad], axis=1)
    return (scene.sphere_pos_radius, scene.sphere_material, cuboid_geom,
            scene.cuboid_material)


def make_table_trace(sphere_geom_ref, sphere_mat_ref, cuboid_geom_ref,
                     cuboid_mat_ref, num_spheres, num_cuboids):
    """The kernel's TraceFn: the shared closest-hit fold over scalar table
    reads, then the winner's attributes as per-lane gathers."""
    scan = make_scan_fn(
        lambda i: tuple(sphere_geom_ref[i, k] for k in range(4)),
        lambda i: tuple(cuboid_geom_ref[i, k] for k in (0, 1, 2, 4, 5, 6)),
        num_spheres, num_cuboids)

    def gather(idx) -> Winner:
        is_sphere = (idx >= 0) & (idx < MAX_SPHERES)
        sidx = jnp.minimum(jnp.maximum(idx, 0), MAX_SPHERES - 1)
        cidx = jnp.minimum(jnp.maximum(idx - MAX_SPHERES, 0), MAX_CUBOIDS - 1)
        mat = tuple(jnp.where(is_sphere, sphere_mat_ref[sidx, k],
                              cuboid_mat_ref[cidx, k])
                    for k in range(MAT_LANES))
        sg = lambda k: sphere_geom_ref[sidx, k]
        cg = lambda k: cuboid_geom_ref[cidx, k]
        return Winner(material=mat,
                      sphere_center=Vec3(sg(0), sg(1), sg(2)),
                      sphere_radius=sg(3),
                      cuboid_min=Vec3(cg(0), cg(1), cg(2)),
                      cuboid_max=Vec3(cg(4), cg(5), cg(6)),
                      is_sphere=is_sphere)

    return compose_trace_fn(scan, gather)


def _block_pixels(ints_ref, width: int, height: int):
    """This program's pixel coordinates: a flat run of BLOCK pixels of the
    (row-banded) frame, rows past the frame clamped to its last row."""
    flat = (pl.program_id(0) * BLOCK
            + jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0))
    px = flat % width
    py = jnp.minimum(flat // width + ints_ref[3], height - 1)
    return px, py


def _counts(ints_ref, counts):
    # Static counts bake the primitive-loop trip counts into the program;
    # dynamic counts (None) read them from the int vector, so one
    # compilation serves any scene.
    if counts is not None:
        return counts
    return ints_ref[1], ints_ref[2]


def _store3(ref, lead, v: Vec3):
    for c in range(3):
        ref[lead + (c, slice(None))] = v[c]


def _kernel(ints_ref, cam_ref, sphere_geom_ref, sphere_mat_ref,
            cuboid_geom_ref, cuboid_mat_ref,
            rad_ref, missd_ref, misst_ref, rays_ref, seed_ref,
            *, width: int, height: int, ray_depth: int, spp: int,
            counts: Tuple[int, int] | None, jitter: str, rr: bool):
    trace_fn = make_table_trace(sphere_geom_ref, sphere_mat_ref,
                                cuboid_geom_ref, cuboid_mat_ref,
                                *_counts(ints_ref, counts))
    px, py = _block_pixels(ints_ref, width, height)
    res = trace_samples(trace_fn, _unpack_cam(cam_ref), px, py, width,
                        height, ints_ref[0], ray_depth, spp, loop="rolled",
                        jitter=jitter, russian_roulette=rr)
    _store3(rad_ref, (), res.radiance)
    for s in range(spp):
        _store3(missd_ref, (s,), res.miss_dir[s])
        _store3(misst_ref, (s,), res.miss_thr[s])
    rays_ref[:] = res.ray_count
    seed_ref[:] = res.seed


def _launch(kernel, ints, cam, scene, outs, interpret):
    """pallas_call over the pixel blocks: the small vectors and the scene
    tables are whole-array inputs, every output is blocked along its last
    (pixel) axis."""
    tables = _scene_tables(scene)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)

    def blocked(o):
        lead = o.shape[:-1]
        return pl.BlockSpec(lead + (BLOCK,),
                            lambda i, n=len(lead): (0,) * n + (i,))

    npad = outs[0].shape[-1]
    return pl.pallas_call(
        kernel,
        grid=(npad // BLOCK,),
        in_specs=[whole(ints), whole(cam)] + [whole(t) for t in tables],
        out_specs=tuple(blocked(o) for o in outs),
        out_shape=outs,
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="tpt_trace", backend="triton",
    )(ints, cam, *tables)


def _pad_pixels(width: int, n_rows: int):
    npix = width * n_rows
    return npix, -(-npix // BLOCK) * BLOCK


def _unflatten(a, npix, n_rows, width):
    """[..., npad] -> [..., n_rows, width]"""
    return a[..., :npix].reshape(a.shape[:-1] + (n_rows, width))


def pallas_trace(scene, inv_proj, inv_view, frame, focal_length,
                 aperture_diameter, *, width: int, height: int,
                 ray_depth: int, spp: int, interpret: bool | None = None,
                 counts: Tuple[int, int] | None = None,
                 n_rows: int | None = None, row0=0, jitter: str = "corner",
                 rr: bool = True) -> TraceResult:
    """Trace every pixel of a width x height frame.

    Returns a TraceResult with batch shape (height, width) — same contract as
    the oracle's trace, so tpt.integrator.apply_environment works on either.

    Row-band mode (the sharded path): ``n_rows``/``row0`` select a horizontal
    band of ``n_rows`` pixel rows starting at traced row index ``row0``; the
    batch shape becomes (n_rows, width).  Camera NDC math still uses the full
    width x height frame, and seeds depend only on absolute pixel coords
    (compute.glsl:106), so a banded render is bit-identical to the matching
    slice of a whole-frame render.
    """
    return _pallas_trace(
        scene, inv_proj, inv_view, frame, focal_length, aperture_diameter,
        row0, width=width, height=height, ray_depth=ray_depth, spp=spp,
        interpret=use_interpreter(interpret), counts=counts,
        n_rows=height if n_rows is None else n_rows, jitter=jitter, rr=rr)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "ray_depth", "spp", "interpret", "counts", "n_rows",
    "jitter", "rr"))
def _pallas_trace(scene, inv_proj, inv_view, frame, focal_length,
                  aperture_diameter, row0, *, width, height, ray_depth, spp,
                  interpret, counts, n_rows, jitter, rr) -> TraceResult:
    npix, npad = _pad_pixels(width, n_rows)
    ints = jnp.stack([jnp.asarray(frame, jnp.int32),
                      scene.num_spheres.astype(jnp.int32),
                      scene.num_cuboids.astype(jnp.int32),
                      jnp.asarray(row0, jnp.int32)])
    ints = jnp.pad(ints, (0, INT_WORDS - ints.shape[0]))
    cam = _pack_cam(inv_proj, inv_view, focal_length, aperture_diameter)
    kernel = functools.partial(_kernel, width=width, height=height,
                               ray_depth=ray_depth, spp=spp, counts=counts,
                               jitter=jitter, rr=rr)
    outs = (jax.ShapeDtypeStruct((3, npad), jnp.float32),
            jax.ShapeDtypeStruct((spp, 3, npad), jnp.float32),
            jax.ShapeDtypeStruct((spp, 3, npad), jnp.float32),
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((npad,), jnp.uint32))
    rad, missd, misst, rays, seed = _launch(kernel, ints, cam, scene, outs,
                                            interpret)
    u = lambda a: _unflatten(a, npix, n_rows, width)
    return TraceResult(radiance=u(rad), miss_dir=u(missd), miss_thr=u(misst),
                       ray_count=u(rays), seed=u(seed))


def _kernel_progressive(ints_ref, cam_ref, sphere_geom_ref, sphere_mat_ref,
                        cuboid_geom_ref, cuboid_mat_ref,
                        rad_ref, missd_ref, misst_ref, rays_ref, seed_ref,
                        *, width: int, height: int, ray_depth: int, spp: int,
                        n_frames: int, counts: Tuple[int, int] | None,
                        jitter: str, rr: bool):
    """Path-regeneration ("refill") kernel: one launch folds ``n_frames``
    frames' samples per lane as a queue (tpt.integrator.trace_progressive's
    in-kernel twin — progressive_iteration is shared verbatim, so the float
    stream is identical).

    Dead-lane economics vs the per-frame kernel: the loop here exits once
    every lane has drained its n_frames * spp sample queue — expected
    iterations ~ n_frames * E[segments] + ONE straggler tail for the whole
    block, where the per-frame kernel pays a tail per frame (the SIMT-break
    gap of compute.glsl:170-179).  The path state is the loop carry; a
    finished sample's miss record is stored straight to its (frame, sample)
    slot, one scattered store per lane.
    """
    trace_fn = make_table_trace(sphere_geom_ref, sphere_mat_ref,
                                cuboid_geom_ref, cuboid_mat_ref,
                                *_counts(ints_ref, counts))
    cam = _unpack_cam(cam_ref)
    frame0 = ints_ref[0]
    n_valid = ints_ref[4]
    px, py = _block_pixels(ints_ref, width, height)
    fpx = px.astype(jnp.float32)
    fpy = py.astype(jnp.float32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    max_iters = n_frames * spp * ray_depth

    def live(carry):
        i, _state, lane_frame = carry[:3]
        return (i < max_iters) & any_lane(lane_frame < n_valid)

    def body(carry):
        i, state, lane_frame, lane_sample, lane_bounce, rad_sum, out_seed = \
            carry
        state, lane_frame, lane_sample, lane_bounce, done, slot = \
            progressive_iteration(
                trace_fn, cam, px, py, fpx, fpy, width, height, frame0,
                ray_depth, spp, n_valid, jitter, rr,
                state, lane_frame, lane_sample, lane_bounce)
        rad_sum = rad_sum + where3(done, state.radiance, 0.0)
        for c in range(3):
            plgpu.store(missd_ref.at[slot, c, lane], state.miss_dir[c],
                        mask=done)
            plgpu.store(misst_ref.at[slot, c, lane], state.miss_thr[c],
                        mask=done)
        out_seed = jnp.where(done, state.seed, out_seed)
        return (i + 1, state, lane_frame, lane_sample, lane_bounce, rad_sum,
                out_seed)

    state, lane_frame, lane_sample, lane_bounce = init_progressive_state(px)
    carry = (jnp.int32(0), state, lane_frame, lane_sample, lane_bounce,
             state.radiance, state.seed)
    _, state, _, _, _, rad_sum, out_seed = jax.lax.while_loop(live, body,
                                                              carry)
    _store3(rad_ref, (), rad_sum)
    rays_ref[:] = state.ray_count
    seed_ref[:] = out_seed


def pallas_trace_progressive(scene, inv_proj, inv_view, frame0, focal_length,
                             aperture_diameter, *, width: int, height: int,
                             ray_depth: int, spp: int, n_frames: int,
                             n_valid=None, interpret: bool | None = None,
                             counts: Tuple[int, int] | None = None,
                             n_rows: int | None = None, row0=0,
                             jitter: str = "corner",
                             rr: bool = True) -> ProgressiveTraceResult:
    """Trace ``n_frames`` consecutive progressive frames in ONE kernel
    launch via path regeneration (see _kernel_progressive).

    Returns a tpt.integrator.ProgressiveTraceResult with batch shape
    (n_rows, width) and per-(frame, sample) miss slots [n_frames * spp];
    slots match the per-frame pallas_trace outputs path-for-path:
    integer outputs (seeds, ray counts — the RNG stream and every discrete
    decision) bit-exactly, floats to last-ulp rounding
    (tests/test_refill.py::test_kernel_refill_*).

    ``n_valid``: optional traced i32 — frames >= n_valid are skipped (their
    slots are zero), so a partial tail chunk reuses the compiled program.
    """
    return _pallas_trace_progressive(
        scene, inv_proj, inv_view, frame0, focal_length, aperture_diameter,
        jnp.int32(n_frames) if n_valid is None else n_valid, row0,
        width=width, height=height, ray_depth=ray_depth, spp=spp,
        n_frames=n_frames, interpret=use_interpreter(interpret),
        counts=counts, n_rows=height if n_rows is None else n_rows,
        jitter=jitter, rr=rr)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "ray_depth", "spp", "n_frames", "interpret", "counts",
    "n_rows", "jitter", "rr"))
def _pallas_trace_progressive(scene, inv_proj, inv_view, frame0,
                              focal_length, aperture_diameter, n_valid, row0,
                              *, width, height, ray_depth, spp, n_frames,
                              interpret, counts, n_rows, jitter, rr):
    n_slots = n_frames * spp
    npix, npad = _pad_pixels(width, n_rows)
    n_valid = jnp.asarray(n_valid, jnp.int32)
    ints = jnp.stack([jnp.asarray(frame0, jnp.int32),
                      scene.num_spheres.astype(jnp.int32),
                      scene.num_cuboids.astype(jnp.int32),
                      jnp.asarray(row0, jnp.int32), n_valid])
    ints = jnp.pad(ints, (0, INT_WORDS - ints.shape[0]))
    cam = _pack_cam(inv_proj, inv_view, focal_length, aperture_diameter)
    kernel = functools.partial(
        _kernel_progressive, width=width, height=height, ray_depth=ray_depth,
        spp=spp, n_frames=n_frames, counts=counts, jitter=jitter, rr=rr)
    outs = (jax.ShapeDtypeStruct((3, npad), jnp.float32),
            jax.ShapeDtypeStruct((n_slots, 3, npad), jnp.float32),
            jax.ShapeDtypeStruct((n_slots, 3, npad), jnp.float32),
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((npad,), jnp.uint32))
    rad, missd, misst, rays, seed = _launch(kernel, ints, cam, scene, outs,
                                            interpret)
    # the kernel writes only the slots of valid frames: zero the rest
    valid = (jnp.arange(n_slots) < n_valid * spp)[:, None, None]
    u = lambda a: _unflatten(a, npix, n_rows, width)
    return ProgressiveTraceResult(
        rad_sum=u(rad), miss_dir=u(jnp.where(valid, missd, 0.0)),
        miss_thr=u(jnp.where(valid, misst, 0.0)), ray_count=u(rays),
        seed=u(seed))
