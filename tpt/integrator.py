"""The light-transport integrator core.

This is a faithful re-derivation of the reference GLSL integrator
(res/shaders/PathTracing/compute.glsl:101-224) in batched, functional form:

  * the per-pixel mutable ``rndSeed`` becomes an explicit uint32 lane state
    whose draw sites advance in exactly the shader's order (including the
    data-dependent extra draws inside the refractive branch), so the random
    stream matches the shader draw-for-draw;
  * ``break`` becomes an alive mask over a fixed-trip bounce loop;
  * the environment lookup for escaped rays is *deferred*: a sample misses at
    most once (the shader breaks immediately after the env fetch), so the
    kernel records (miss_direction, throughput-at-miss) per sample and the
    cubemap fetch happens afterwards in plain XLA.  This is exact — nothing
    downstream of a miss depends on the fetched value.

Deliberate, documented deviations from the shader (which hits undefined
behavior in these spots):
  * total internal reflection with zero refraction roughness: the shader
    normalizes a zero vector (NaN); we fall back to the mirror reflection
    direction (the physically correct TIR behavior);
  * normalize() of degenerate vectors is floored at 1e-20 squared length.

Everything is shape-polymorphic over the pixel batch: the oracle calls it on
[H, W] grids, the Pallas kernel on one block of pixels, with scene access
injected via ``scan_fn``/``gather_fn``.  Vectors are :class:`tpt.vecmath.Vec3`
component triples, so every value is a plain per-lane array.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import rng
from .config import MAX_SPHERES, KERNEL_EPSILON
from .vecmath import (Vec3, dot3, max3, mix, mix3, normalize3, splat3,
                      stack3, v3map, where3)
from .ops.intersect import (FLOAT_MAX, ray_sphere, ray_cuboid,
                            smallest_positive, sphere_normal, cuboid_normal)
from .ops.sampling import cosine_sample_hemisphere, uniform_sample_unit_circle
from .ops.bsdf_math import fresnel_schlick, reflect3, refract3
from .env import sample_environment_planar

EPS = np.float32(KERNEL_EPSILON)


class Winner(NamedTuple):
    """Per-lane attributes of the closest-hit primitive."""
    material: Tuple[jax.Array, ...]  # MAT_LANES x f32[*batch] (tpt.materials)
    sphere_center: Vec3
    sphere_radius: jax.Array  # f32[*batch]
    cuboid_min: Vec3
    cuboid_max: Vec3
    is_sphere: jax.Array      # bool[*batch]


MAT_LANES = 14  # material lanes 0..13 (14, 15 are std140 padding)


class CameraParams(NamedTuple):
    """Camera inputs as plain scalars (no small-vector construction inside
    kernels; scalars broadcast to the pixel block).

    ``ip??`` are inverse-projection elements used by the eye-ray transform;
    ``right``/``up``/``backward``/``eye`` are the inverse-view columns."""
    ip00: jax.Array
    ip01: jax.Array
    ip02: jax.Array
    ip10: jax.Array
    ip11: jax.Array
    ip12: jax.Array
    right: Tuple[jax.Array, jax.Array, jax.Array]
    up: Tuple[jax.Array, jax.Array, jax.Array]
    backward: Tuple[jax.Array, jax.Array, jax.Array]
    eye: Tuple[jax.Array, jax.Array, jax.Array]
    focal_length: jax.Array
    aperture_diameter: jax.Array


def camera_params(inv_proj, inv_view, focal_length, aperture_diameter) -> CameraParams:
    """Build CameraParams from 4x4 inverse matrices (element extraction only).

    The view position is inv_view's translation column — identical to the
    ViewPos the reference uploads (Camera.Position, src/MainWindow.cs:132)."""
    col = lambda j: (inv_view[0, j], inv_view[1, j], inv_view[2, j])
    return CameraParams(
        ip00=inv_proj[0, 0], ip01=inv_proj[0, 1], ip02=inv_proj[0, 2],
        ip10=inv_proj[1, 0], ip11=inv_proj[1, 1], ip12=inv_proj[1, 2],
        right=col(0), up=col(1), backward=col(2), eye=col(3),
        focal_length=jnp.asarray(focal_length, jnp.float32),
        aperture_diameter=jnp.asarray(aperture_diameter, jnp.float32),
    )


# scan_fn(origin, direction) -> (found bool[B], idx i32[B], t f32[B], inside bool[B])
ScanFn = Callable[[jax.Array, jax.Array], Tuple[jax.Array, jax.Array, jax.Array, jax.Array]]
# gather_fn(idx) -> Winner
GatherFn = Callable[[jax.Array], Winner]
# trace_fn(origin, direction) -> (found, t, inside, Winner)
TraceFn = Callable[[jax.Array, jax.Array],
                   Tuple[jax.Array, jax.Array, jax.Array, Winner]]


def compose_trace_fn(scan_fn: ScanFn, gather_fn: GatherFn) -> TraceFn:
    """Closest-hit trace as scan + winner gather (the oracle path)."""

    def trace(origin, direction):
        found, idx, t, inside = scan_fn(origin, direction)
        return found, t, inside, gather_fn(idx)

    return trace


def make_scan_fn(get_sphere, get_cuboid, num_spheres, num_cuboids) -> ScanFn:
    """Sequential closest-hit fold in the shader's scan order
    (compute.glsl:226-258): all spheres first, then all cuboids, keeping a
    candidate when ``t2 > 0 && t1 < bestT``.  The fold is order-dependent
    (a candidate's raw t1 — possibly negative — is compared against the
    incumbent's smallest-positive T), which we reproduce exactly.

    ``get_sphere(i) -> (cx, cy, cz, r)`` and
    ``get_cuboid(i) -> (mnx, mny, mnz, mxx, mxy, mxz)`` return scalars;
    the oracle reads jnp arrays, the Pallas kernel reads its table refs.
    """

    def scan(origin, direction):
        batch = origin.x.shape
        best_t = jnp.full(batch, FLOAT_MAX, jnp.float32)
        best_idx = jnp.full(batch, -1, jnp.int32)
        best_inside = jnp.zeros(batch, jnp.int32)

        def consider(carry, t1, t2, ok, idx):
            b_t, b_idx, b_in = carry
            cond = ok & (t2 > 0.0) & (t1 < b_t)
            t = smallest_positive(t1, t2)
            inside = (t == t2).astype(jnp.int32)
            return (jnp.where(cond, t, b_t),
                    jnp.where(cond, idx, b_idx),
                    jnp.where(cond, inside, b_in))

        def sphere_body(i, carry):
            cx, cy, cz, r = get_sphere(i)
            center = splat3((cx, cy, cz), batch)
            t1, t2, ok = ray_sphere(origin, direction, center, r)
            return consider(carry, t1, t2, ok, i)

        def cuboid_body(i, carry):
            mnx, mny, mnz, mxx, mxy, mxz = get_cuboid(i)
            mn = splat3((mnx, mny, mnz), batch)
            mx = splat3((mxx, mxy, mxz), batch)
            t1, t2, ok = ray_cuboid(origin, direction, mn, mx)
            return consider(carry, t1, t2, ok, MAX_SPHERES + i)

        carry = (best_t, best_idx, best_inside)
        carry = jax.lax.fori_loop(0, num_spheres, sphere_body, carry)
        carry = jax.lax.fori_loop(0, num_cuboids, cuboid_body, carry)
        best_t, best_idx, best_inside = carry
        # found-check via T != FLOAT_MAX — the shader's convention
        # (compute.glsl:257), kept identical in every implementation
        return best_t != FLOAT_MAX, best_idx, best_t, best_inside != 0

    return scan


def make_xla_gather_fn(scene) -> GatherFn:
    """Winner-attribute gather via XLA gathers (oracle path)."""

    def gather(idx) -> Winner:
        is_sphere = (idx >= 0) & (idx < MAX_SPHERES)
        sidx = jnp.clip(idx, 0, MAX_SPHERES - 1)
        cidx = jnp.clip(idx - MAX_SPHERES, 0, scene.cuboid_min.shape[0] - 1)
        smat = scene.sphere_material[sidx]        # [*batch, 16]
        cmat = scene.cuboid_material[cidx]
        mat = tuple(jnp.where(is_sphere, smat[..., k], cmat[..., k])
                    for k in range(MAT_LANES))
        spr = scene.sphere_pos_radius[sidx]
        cmin = scene.cuboid_min[cidx]
        cmax = scene.cuboid_max[cidx]
        return Winner(
            material=mat,
            sphere_center=Vec3(spr[..., 0], spr[..., 1], spr[..., 2]),
            sphere_radius=spr[..., 3],
            cuboid_min=Vec3(cmin[..., 0], cmin[..., 1], cmin[..., 2]),
            cuboid_max=Vec3(cmax[..., 0], cmax[..., 1], cmax[..., 2]),
            is_sphere=is_sphere,
        )

    return gather


def make_scene_scan_fn(scene, counts: Tuple[int, int] | None = None) -> ScanFn:
    """Oracle scan over a Scene pytree's padded arrays.

    ``counts``: optional static (n_spheres, n_cuboids).  Needed when the scan
    will be reverse-mode differentiated — jax.grad cannot transpose loops
    with traced trip counts."""

    def get_sphere(i):
        row = jax.lax.dynamic_index_in_dim(scene.sphere_pos_radius, i, 0, keepdims=False)
        return row[0], row[1], row[2], row[3]

    def get_cuboid(i):
        mn = jax.lax.dynamic_index_in_dim(scene.cuboid_min, i, 0, keepdims=False)
        mx = jax.lax.dynamic_index_in_dim(scene.cuboid_max, i, 0, keepdims=False)
        return mn[0], mn[1], mn[2], mx[0], mx[1], mx[2]

    ns, nc = counts if counts is not None else (scene.num_spheres, scene.num_cuboids)
    return make_scan_fn(get_sphere, get_cuboid, ns, nc)


@dataclasses.dataclass(frozen=True)
class PathState:
    """Per-lane bounce-loop carry."""
    origin: Vec3
    direction: Vec3
    throughput: Vec3
    radiance: Vec3          # emission picked up so far
    seed: jax.Array         # u32[B]
    alive: jax.Array        # i32[B] (0/1)
    miss_dir: Vec3          # direction at escape (0 if none yet)
    miss_thr: Vec3          # throughput at escape (0 if none)
    ray_count: jax.Array    # i32[B]      traced segments (for Mrays/s)


jax.tree_util.register_dataclass(PathState)


def bounce_step(state: PathState, trace_fn: TraceFn,
                russian_roulette: bool = True) -> PathState:
    """One bounce of the Radiance loop (compute.glsl:132-182).

    ``russian_roulette=False`` disables the RR termination/reweighting
    (compute.glsl:166-173) for DIFFERENTIABLE transport: with RR active,
    a surviving path's throughput is divided by p_max = max(throughput),
    so survivor values depend only on albedo RATIOS — the albedo scale is
    carried entirely by the (detached, discrete) survival decisions, and a
    pixel-loss optimizer against a matched-RNG target can freely rescale
    albedos at near-zero loss (r4 diagnosis: single-sphere recovery froze
    at |d albedo| ~ 0.14-0.35 under every RR gradient treatment).  Fixed-
    depth transport keeps the full albedo dependence in the throughput —
    with matched seeds and material-only optimization there are NO
    discrete flips at all, so the loss is genuinely smooth.  The RR roll
    is still drawn, keeping the RNG stream aligned with rr=True draw-for-
    draw.  Rendering keeps rr=True (the reference's behavior)."""
    o, d, thr, rad, seed = (state.origin, state.direction, state.throughput,
                            state.radiance, state.seed)
    alive = state.alive != 0

    found, t, inside, w = trace_fn(o, d)
    ray_count = state.ray_count + state.alive
    hit = alive & found
    miss = alive & ~found

    mat = w.material
    albedo = Vec3(*mat[0:3])
    spec0 = mat[3]
    emissive = Vec3(*mat[4:7])
    spec_rough = mat[7]
    absorb = Vec3(*mat[8:11])
    refr0 = mat[11]
    refr_rough = mat[12]
    ior = mat[13]

    # Safe-where hygiene: every input that is +-inf/garbage on masked-out
    # lanes is neutralized *before* entering differentiable math — a masked
    # jnp.where blocks NaN values but not NaN gradients (0-cotangent times
    # an infinite local derivative is NaN).  Forward results are unchanged:
    # the masked lanes never contribute.
    t_safe = jnp.where(found, t, 1.0)            # miss lanes carry FLOAT_MAX
    ior_safe = jnp.maximum(ior, EPS)             # padded materials carry 0

    hp = o + d * t_safe
    n_raw = where3(w.is_sphere,
                   sphere_normal(w.sphere_center,
                                 jnp.maximum(w.sphere_radius, EPS), hp),
                   cuboid_normal(w.cuboid_min, w.cuboid_max, hp))
    n = where3(inside, -n_raw, n_raw)

    # Beer's law when exiting a medium (compute.glsl:145-149)
    t_beer = jnp.where(hit & inside, t_safe, 0.0)
    thr = where3(hit & inside, thr * v3map(jnp.exp, -absorb * t_beer), thr)

    # --- BSDF lobe probabilities (compute.glsl:184-195) ---
    n1 = jnp.where(inside, ior_safe, 1.0)
    n2 = jnp.where(inside, 1.0, ior_safe)
    fres = fresnel_schlick(dot3(-d, n), n1, n2)
    spec_f = mix(spec0, jnp.float32(1.0), fres)
    diffuse_c = 1.0 - spec_f - refr0
    spec = jnp.where(spec0 > 0.0, spec_f, spec0)
    refr = jnp.where(spec0 > 0.0, 1.0 - spec_f - diffuse_c, refr0)

    # --- RNG draws, in shader order ---
    r_z, s1 = rng.random_float01(seed)
    r_a, s2 = rng.random_float01(s1)
    diffuse_ray = cosine_sample_hemisphere(n, r_z, r_a)
    roll, s3 = rng.random_float01(s2)
    take_spec = spec > roll
    take_refr = (~take_spec) & (spec + refr > roll)
    r_z2, s4 = rng.random_float01(s3)
    r_a2, s5 = rng.random_float01(s4)
    seed_after_bsdf = jnp.where(take_refr, s5, s3)

    # --- lobe directions ---
    refl_pure = reflect3(d, n)
    refl_dir = normalize3(mix3(refl_pure, diffuse_ray, spec_rough * spec_rough),
                          eps=np.float32(1e-20))
    eta = jnp.where(inside, ior_safe, 1.0 / ior_safe)
    refr_raw, _tir = refract3(d, n, eta)
    hemi_neg = cosine_sample_hemisphere(-n, r_z2, r_a2)
    refr_mixed = mix3(refr_raw, hemi_neg, refr_rough * refr_rough)
    refr_len2 = dot3(refr_mixed, refr_mixed)
    # TIR with ~zero roughness degenerates to the zero vector (shader UB);
    # defined policy: mirror reflection.
    refr_dir = where3(refr_len2 > 1e-12,
                      refr_mixed / jnp.sqrt(jnp.maximum(refr_len2, np.float32(1e-12))),
                      refl_pure)

    new_d = where3(take_spec, refl_dir, where3(take_refr, refr_dir, diffuse_ray))
    p = jnp.where(take_spec, spec,
                  jnp.where(take_refr, refr, 1.0 - spec - refr))
    p = jnp.maximum(p, EPS)
    new_o = hp + new_d * EPS

    # --- throughput / radiance updates (compute.glsl:156-164) ---
    rad = rad + where3(hit, emissive * thr, jnp.float32(0.0))
    thr_after = where3(hit & ~take_refr, thr * albedo, thr)
    thr_after = where3(hit, thr_after / p, thr_after)

    # --- Russian roulette (compute.glsl:166-173) ---
    p_max = max3(thr_after)
    rr_roll, s6 = rng.random_float01(seed_after_bsdf)
    if russian_roulette:
        die = rr_roll > p_max
        survive = hit & ~die
        p_max_safe = jnp.where(survive, p_max, 1.0)
        thr_after = where3(survive, thr_after / p_max_safe, thr_after)
    else:
        die = jnp.zeros_like(hit)
        survive = hit

    # --- escaped rays: defer the environment fetch ---
    miss_dir = where3(miss, d, state.miss_dir)
    miss_thr = where3(miss, thr, state.miss_thr)

    return PathState(
        origin=where3(hit, new_o, o),
        direction=where3(hit, new_d, d),
        throughput=where3(hit, thr_after, thr),
        radiance=rad,
        seed=jnp.where(hit, s6, seed),
        alive=(hit & ~die).astype(jnp.int32),
        miss_dir=miss_dir,
        miss_thr=miss_thr,
        ray_count=ray_count,
    )


def sample_draws(seed):
    """The four per-sample RNG draws preceding the bounce loop, in shader
    order (compute.glsl:113-119): sub-pixel jitter x/y, lens angle, lens
    radius.  Returns ((jx, jy, r_angle, r_radius), seed_after)."""
    jx, seed = rng.random_float01(seed)
    jy, seed = rng.random_float01(seed)
    r_angle, seed = rng.random_float01(seed)
    r_radius, seed = rng.random_float01(seed)
    return (jx, jy, r_angle, r_radius), seed


def primary_ray(cam: CameraParams, fpx, fpy, width: int, height: int,
                draws, jitter: str = "corner"):
    """Jittered thin-lens eye ray (compute.glsl:113-121,352-357).

    ``draws``: sample_draws floats.  Differentiable w.r.t. every CameraParams
    entry (camera/lens cotangents of the rendered image flow through it)."""
    jx, jy, r_angle, r_radius = draws
    batch = fpx.shape
    right = splat3(cam.right, batch)
    up = splat3(cam.up, batch)
    backward = splat3(cam.backward, batch)
    eye = splat3(cam.eye, batch)

    if jitter == "corner":
        u = (fpx + jx) / width * 2.0 - 1.0
        v = (fpy + jy) / height * 2.0 - 1.0
    else:
        u = ((fpx + 0.5) / width + (jx - 0.5) / width) * 2.0 - 1.0
        v = ((fpy + 0.5) / height + (jy - 0.5) / height) * 2.0 - 1.0

    # eye ray (compute.glsl:352-357): invP @ (u, v, -1, 0), zw := (-1, 0)
    ex = cam.ip00 * u + cam.ip01 * v - cam.ip02
    ey = cam.ip10 * u + cam.ip11 * v - cam.ip12
    d = normalize3(right * ex + up * ey - backward)
    o = eye  # ViewPos == inv_view translation (src/MainWindow.cs:132)

    # thin-lens DoF (compute.glsl:117-121)
    focal_point = o + d * jnp.broadcast_to(
        jnp.asarray(cam.focal_length, jnp.float32), batch)
    cx, cy = uniform_sample_unit_circle(r_angle, r_radius)
    ap = jnp.asarray(cam.aperture_diameter, jnp.float32)
    off_x = ap * 0.5 * cx
    off_y = ap * 0.5 * cy
    o = eye + right * off_x + up * off_y
    d = normalize3(focal_point - o)
    return o, d


class TraceResult(NamedTuple):
    radiance: jax.Array    # f32[3, B]        emission-path radiance, summed over spp
    miss_dir: jax.Array    # f32[spp, 3, B]   escape directions (0 where none)
    miss_thr: jax.Array    # f32[spp, 3, B]   throughput at escape (0 where none)
    ray_count: jax.Array   # i32[B]           traced segments
    seed: jax.Array        # u32[B]           final RNG state


class SampleResult(NamedTuple):
    """:func:`trace_samples` output: a TraceResult whose vectors are Vec3
    values (one per sample for the miss fields) instead of stacked arrays."""
    radiance: Vec3
    miss_dir: Tuple[Vec3, ...]
    miss_thr: Tuple[Vec3, ...]
    ray_count: jax.Array
    seed: jax.Array

    def stacked(self) -> TraceResult:
        return TraceResult(
            radiance=stack3(self.radiance),
            miss_dir=jnp.stack([stack3(v) for v in self.miss_dir]),
            miss_thr=jnp.stack([stack3(v) for v in self.miss_thr]),
            ray_count=self.ray_count, seed=self.seed)


def any_lane(mask):
    """Whether any lane of the batch is set: one predicate for the whole
    batch (a max, which every backend reduces, rather than a boolean or)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


BOUNCE_LOOPS = ("skip", "remat", "rolled")


def trace_samples(trace_fn: TraceFn, cam: CameraParams,
                  px, py, width: int, height: int, frame,
                  ray_depth: int, spp: int, *, loop: str = "skip",
                  jitter: str = "corner",
                  russian_roulette: bool = True) -> SampleResult:
    """Full per-pixel sampling loop (compute.glsl:101-130), environment
    fetch deferred.  ``px``/``py`` are integer pixel coords (GL convention:
    y bottom-up) of any batch shape.

    ``loop`` picks how the bounce loop runs; all three give the same
    result, because a bounce on a batch whose lanes are all dead is the
    identity:
      * ``"skip"`` — unrolled; after the first bounce, a ``lax.cond``
        skips whole bounces once every lane is dead (Russian roulette keeps
        E[bounces] far below ray_depth; the reference relies on per-thread
        ``break`` the same way).  The oracle's default.
      * ``"remat"`` — unrolled, every bounce under ``jax.checkpoint`` and
        none skipped: reverse mode stores only the inter-bounce carry and
        recomputes each bounce's internals in the backward sweep.
      * ``"rolled"`` — one ``while_loop`` over bounces that exits once the
        whole batch is dead: the GPU kernel's form, one loop body in the
        program whatever the depth (not reverse-differentiable).

    ``jitter`` selects the reference's sub-pixel jitter arithmetic:
      * ``"corner"`` — the compute variant: ndc = (p + rand01)/size*2-1
        (compute.glsl:113-114);
      * ``"center"`` — the fragment variant, the reference app's ACTIVE
        default (PathTracer.cs:1 defines _USE_COMPUTE, underscore, so the
        fragment path ships): ndc = (texcoord + (rand01-0.5)/size)*2-1 with
        texcoord = (p+0.5)/size (fragCompute.glsl:115-116).
    The two are ALGEBRAICALLY IDENTICAL — (p+0.5+rand-0.5) == (p+rand) —
    both integrate uniformly over the pixel footprint with the same RNG
    draws; they differ only in floating-point rounding order (ulp-level NDC
    deltas, quantified by tests/test_jitter.py).  "corner" is the default
    everywhere; "center" reproduces the shipped app's exact rounding."""
    if jitter not in ("corner", "center"):
        raise ValueError(f"jitter must be 'corner' or 'center', got {jitter!r}")
    if loop not in BOUNCE_LOOPS:
        raise ValueError(f"loop must be one of {BOUNCE_LOOPS}, got {loop!r}")
    seed = rng.pixel_seed(px, py, frame)
    fpx = jnp.asarray(px, jnp.float32)
    fpy = jnp.asarray(py, jnp.float32)

    zero_lane = fpx * 0.0
    zero_v3 = Vec3(zero_lane, zero_lane, zero_lane)
    rad_total = zero_v3
    ray_count = jnp.asarray(px, jnp.int32) * 0
    miss_dirs = []
    miss_thrs = []

    def bounce(st):
        return bounce_step(st, trace_fn, russian_roulette)

    for _ in range(spp):
        draws, seed = sample_draws(seed)
        o, d = primary_ray(cam, fpx, fpy, width, height, draws, jitter)

        state = PathState(
            origin=o, direction=d,
            throughput=zero_v3 + 1.0,
            radiance=zero_v3,
            seed=seed,
            alive=ray_count * 0 + 1,
            miss_dir=zero_v3,
            miss_thr=zero_v3,
            ray_count=ray_count,
        )
        if loop == "remat":
            step = jax.checkpoint(bounce)
            for _bounce in range(ray_depth):
                state = step(state)
        elif loop == "rolled":
            def live(carry):
                b, st = carry
                return (b < ray_depth) & any_lane(st.alive != 0)

            _, state = jax.lax.while_loop(
                live, lambda c: (c[0] + 1, bounce(c[1])),
                (jnp.int32(0), state))
        else:
            for _bounce in range(ray_depth):
                state = bounce(state) if _bounce == 0 else jax.lax.cond(
                    any_lane(state.alive != 0), bounce, lambda st: st, state)

        rad_total = rad_total + state.radiance
        miss_dirs.append(state.miss_dir)
        miss_thrs.append(state.miss_thr)
        seed = state.seed
        ray_count = state.ray_count

    return SampleResult(radiance=rad_total, miss_dir=tuple(miss_dirs),
                        miss_thr=tuple(miss_thrs), ray_count=ray_count,
                        seed=seed)


def trace_paths(trace_fn: TraceFn, cam: CameraParams,
                px, py, width: int, height: int, frame,
                ray_depth: int, spp: int, loop: str = "skip",
                jitter: str = "corner",
                russian_roulette: bool = True) -> TraceResult:
    """:func:`trace_samples` with stacked outputs (the module-boundary
    TraceResult layout)."""
    return trace_samples(trace_fn, cam, px, py, width, height, frame,
                         ray_depth, spp, loop=loop, jitter=jitter,
                         russian_roulette=russian_roulette).stacked()


class ProgressiveTraceResult(NamedTuple):
    rad_sum: jax.Array     # f32[3, B]      emission radiance SUMMED over all frames
    miss_dir: jax.Array    # f32[F*spp, 3, B]  escape dir per (frame, sample) slot
    miss_thr: jax.Array    # f32[F*spp, 3, B]  throughput at escape per slot
    ray_count: jax.Array   # i32[B]         traced segments, all frames
    seed: jax.Array        # u32[B]         final RNG state (last started sample)


def init_progressive_state(px):
    """Empty refill-loop carry for :func:`progressive_iteration`: every lane
    dead, so the first iteration starts each lane's first sample."""
    zero_lane = jnp.asarray(px, jnp.float32) * 0.0
    zero_i = jnp.asarray(px, jnp.int32) * 0
    zero_v3 = Vec3(zero_lane, zero_lane, zero_lane)
    state = PathState(origin=zero_v3, direction=zero_v3 + 1.0,
                      throughput=zero_v3, radiance=zero_v3,
                      seed=zero_i.astype(jnp.uint32),
                      alive=zero_i, miss_dir=zero_v3, miss_thr=zero_v3,
                      ray_count=zero_i)
    # (state, lane_frame, lane_sample, lane_bounce)
    return state, zero_i, zero_i, zero_i


def trace_progressive(trace_fn: TraceFn, cam: CameraParams,
                      px, py, width: int, height: int, frame0,
                      ray_depth: int, spp: int, n_frames: int,
                      n_valid=None, jitter: str = "corner",
                      russian_roulette: bool = True,
                      iter_hook=None) -> ProgressiveTraceResult:
    """Path-regeneration ("refill") sampling loop over ``n_frames``
    progressive frames — a wide machine's answer to SIMT early-exit.

    The per-frame loop pays ``ray_depth`` masked bounces per sample on a
    batch until its last lane dies, even though Russian roulette ends most
    paths after ~2.7 segments: RR's per-lane binomial tail keeps one
    straggler per batch alive to depth ~15.  Here each lane treats its
    pixel's samples for ``n_frames`` consecutive frames as a QUEUE: the
    moment its path ends (miss / RR death / depth), the lane flushes the
    sample's results and starts the next sample on the very next iteration.
    Dead-lane waste is only the FINAL tail, amortized over the whole block:
    iterations ~ n_frames * E[segments] + tail instead of
    n_frames * ray_depth.

    Equivalences vs ``n_frames`` sequential :func:`trace_paths` calls:
      * integer-exact: the RNG stream (a frame's first sample reseeds from
        pixel_seed(px, py, frame0 + f); later samples chain the running
        seed), every discrete decision, the final seeds, and the per-lane
        ray counts are identical — the paths traced are the same paths;
      * float: radiance flushes into ``rad_sum`` in sample order and slot
        ``f*spp + s`` of ``miss_dir``/``miss_thr`` matches
        trace_paths(frame0 + f)'s sample-s record, to within last-ulp
        rounding — the restructured program gives XLA different fusion
        contexts for the same arithmetic (tests/test_refill.py pins both
        properties).

    ``n_valid``: optional traced i32 — frames ``f >= n_valid`` are skipped
    entirely (their slots stay zero), letting a partial tail chunk reuse
    the compiled program.  ``iter_hook(i, cond)``: test seam — called per
    iteration with the would-run predicate (used to count live iterations).

    The caller applies the environment per slot and folds the block into a
    progressive accumulator as a single running mean:
    ``acc' = (n0*acc + sum_f frame_f) / (n0 + F)`` — algebraically equal to
    the reference's per-frame ``mix(last, new, 1/(frame+1))``
    (compute.glsl:128), differing only in rounding order.
    """
    if jitter not in ("corner", "center"):
        raise ValueError(f"jitter must be 'corner' or 'center', got {jitter!r}")
    if n_valid is None:
        n_valid = jnp.int32(n_frames)
    n_slots = n_frames * spp
    fpx = jnp.asarray(px, jnp.float32)
    fpy = jnp.asarray(py, jnp.float32)

    state, lane_frame, lane_sample, lane_bounce = init_progressive_state(px)
    zero_v3 = state.radiance
    rad_sum = zero_v3
    miss_dir = [zero_v3 for _ in range(n_slots)]
    miss_thr = [zero_v3 for _ in range(n_slots)]
    out_seed = state.seed

    max_iters = n_frames * spp * ray_depth

    def iteration(carry):
        (state, lane_frame, lane_sample, lane_bounce, rad_sum,
         miss_dir, miss_thr, out_seed) = carry
        state, lane_frame, lane_sample, lane_bounce, done, slot = \
            progressive_iteration(
                trace_fn, cam, px, py, fpx, fpy, width, height, frame0,
                ray_depth, spp, n_valid, jitter, russian_roulette,
                state, lane_frame, lane_sample, lane_bounce)
        # ---- flush completed samples into the (functional) slot lists ----
        rad_sum = rad_sum + where3(done, state.radiance, 0.0)
        miss_dir = [where3(done & (slot == k), state.miss_dir, miss_dir[k])
                    for k in range(n_slots)]
        miss_thr = [where3(done & (slot == k), state.miss_thr, miss_thr[k])
                    for k in range(n_slots)]
        out_seed = jnp.where(done, state.seed, out_seed)
        return (state, lane_frame, lane_sample, lane_bounce, rad_sum,
                miss_dir, miss_thr, out_seed)

    carry = (state, lane_frame, lane_sample, lane_bounce, rad_sum,
             miss_dir, miss_thr, out_seed)
    for i in range(max_iters):
        # skip whole iterations once every lane has drained its queue
        # (cond(False) is the identity) — the amortized analogue of the
        # per-frame loop's all-dead skip
        cond = any_lane(carry[1] < n_valid)
        if iter_hook is not None:
            iter_hook(i, cond)
        carry = jax.lax.cond(cond, iteration, lambda c: c, carry)

    (state, lane_frame, lane_sample, lane_bounce, rad_sum,
     miss_dir, miss_thr, out_seed) = carry
    return ProgressiveTraceResult(
        rad_sum=stack3(rad_sum),
        miss_dir=jnp.stack([stack3(v) for v in miss_dir]),
        miss_thr=jnp.stack([stack3(v) for v in miss_thr]),
        ray_count=state.ray_count,
        seed=out_seed,
    )


def progressive_iteration(trace_fn: TraceFn, cam: CameraParams, px, py,
                          fpx, fpy, width: int, height: int, frame0,
                          ray_depth: int, spp: int, n_valid,
                          jitter: str, russian_roulette: bool,
                          state: PathState, lane_frame, lane_sample,
                          lane_bounce):
    """One refill-loop iteration: restart ended lanes on their next queued
    sample, bounce every live lane, mark completions, advance the queue.

    Shared verbatim by the oracle (:func:`trace_progressive`) and the
    Pallas kernel (tpt.kernels.trace, refill mode) so both execute the
    same float operations in the same order — the kernel differs only in
    how it stores the flushed per-sample results (stores to its outputs vs
    functional lists).

    Returns (state', lane_frame', lane_sample', lane_bounce', done, slot):
    ``done`` lanes just completed a sample whose results are still readable
    in ``state'`` (radiance / miss_dir / miss_thr / seed); ``slot`` is the
    completed sample's flat index ``frame*spp + sample``; ``state'.alive``
    is already cleared on them.  ``lane_frame``/``slot`` on done lanes are
    post-/pre-advance respectively.
    """
    zero_v3 = state.origin * 0.0
    has_work = lane_frame < n_valid

    # ---- refill: start the next queued sample on lanes whose path ended.
    # A frame's first sample reseeds from the pixel hash (the per-frame
    # contract, compute.glsl:106); later samples chain the running seed
    # exactly like trace_samples's spp loop.
    start = has_work & (state.alive == 0)
    fresh = rng.pixel_seed(px, py, frame0 + lane_frame)
    seed0 = jnp.where(start,
                      jnp.where(lane_sample == 0, fresh, state.seed),
                      state.seed)
    draws, seed1 = sample_draws(seed0)
    o, d = primary_ray(cam, fpx, fpy, width, height, draws, jitter)
    state = PathState(
        origin=where3(start, o, state.origin),
        direction=where3(start, d, state.direction),
        throughput=where3(start, zero_v3 + 1.0, state.throughput),
        radiance=where3(start, zero_v3, state.radiance),
        seed=jnp.where(start, seed1, state.seed),
        alive=jnp.where(start, state.alive * 0 + 1, state.alive),
        miss_dir=where3(start, zero_v3, state.miss_dir),
        miss_thr=where3(start, zero_v3, state.miss_thr),
        ray_count=state.ray_count,
    )
    lane_bounce = jnp.where(start, lane_bounce * 0, lane_bounce)

    # ---- one bounce on every live lane ----
    state = bounce_step(state, trace_fn, russian_roulette)
    lane_bounce = lane_bounce + has_work.astype(jnp.int32)

    # ---- completion + queue advance ----
    done = has_work & ((state.alive == 0) | (lane_bounce >= ray_depth))
    slot = lane_frame * spp + lane_sample
    last_sample = lane_sample == (spp - 1)
    lane_frame = jnp.where(done & last_sample, lane_frame + 1, lane_frame)
    lane_sample = jnp.where(done,
                            jnp.where(last_sample, lane_sample * 0,
                                      lane_sample + 1),
                            lane_sample)
    state = dataclasses.replace(
        state, alive=jnp.where(done, state.alive * 0, state.alive))
    return state, lane_frame, lane_sample, lane_bounce, done, slot


def apply_environment(result: TraceResult, env_faces, spp: int):
    """Add the deferred environment term and average over spp.

    Returns the frame's per-pixel mean radiance, f32[3, B]."""
    rad = result.radiance
    for s in range(spp):
        envc = sample_environment_planar(env_faces, result.miss_dir[s])
        rad = rad + result.miss_thr[s] * envc
    return rad / np.float32(spp)


def apply_environment_blocked(result: TraceResult, env_table, spp: int):
    """apply_environment on the production fetch path: one row gather per
    sample from a tpt.env.pack_block_table table (bit-identical values)."""
    from .env import sample_environment_blocked
    rad = result.radiance
    for s in range(spp):
        envc = sample_environment_blocked(env_table, result.miss_dir[s])
        rad = rad + result.miss_thr[s] * envc
    return rad / np.float32(spp)
