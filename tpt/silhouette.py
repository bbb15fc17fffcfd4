"""Silhouette (visibility-boundary) gradients for sphere geometry.

The detached-decision estimator used everywhere else in tpt differentiates
only the CONTINUOUS factors of the transport; the closest-hit winner is
detached, so the term "moving a sphere changes WHICH pixels it covers" is
dropped.  That term is a line integral over the object's silhouette
(Li et al. 2018, "Differentiable Monte Carlo Ray Tracing through Edge
Sampling"), and without it interior-only gradients actively mislead —
r4's probes showed a sphere's radius inflating to reduce interior
residuals while the silhouette penalty stayed invisible
(benchmarks/inverse_demo.py docstring, PERF.md).

This module adds the missing boundary term for SPHERE position/radius on
the primary (camera) hit, where it dominates.  A sphere's silhouette from
a pinhole eye is an exact circle — no edge detection or rejection
sampling needed:

  eye o, center c, radius r, L = |c - o|:
    tangency circle center  m = c - (r^2/L) * (c-o)/L
    tangency circle radius  rho = r * sqrt(1 - (r/L)^2)

The estimator samples M stratified points on that circle, projects them
to the screen, and accumulates for each loss-coupled parameter theta:

    dL/dtheta  +=  sum_j  l'(x_j) . (f_in - f_out)(x_j)
                          * (n_hat_j . d x_j/d theta) * dsigma_j

with l' = the pixel-loss derivative at the edge pixel, f_in/f_out =
radiance just inside/outside the silhouette (two eye rays offset +-eps
pixels along the screen normal — occlusion needs no explicit test: where
another object covers the edge, f_in == f_out and the term vanishes),
n_hat = outward screen normal of the projected curve, dsigma = the
screen arc-length element.  The screen positions x_j(c, r) are exact
functions of the sphere parameters, so their velocities come from
jax.jacfwd — no finite differences anywhere in the estimator.

Scope and assumptions (documented bias):
  * primary-visibility boundaries only (the reference scenes' dominant
    term); secondary silhouettes (shadows, reflections of edges) remain
    detached;
  * pinhole camera (aperture 0) for the edge projection — a thin-lens
    silhouette is blurred over the aperture, which this estimator
    ignores;
  * f_in/f_out are 1-sample Monte-Carlo estimates per edge point (seeded
    per frame): unbiased in expectation, averaged over edge samples.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import rng
from .camera import camera_matrices, look_at, perspective, view_direction
from .config import CameraConfig
from .env import sample_environment_planar
from .integrator import (PathState, bounce_step, camera_params,
                         compose_trace_fn, make_scene_scan_fn,
                         make_xla_gather_fn, primary_ray, sample_draws)
from .vecmath import Vec3, stack3


def forward_matrices(cam: CameraConfig, width: int, height: int):
    """Forward view/projection consistent with camera_matrices' inverses:
    ndc = proj @ (view @ [p, 1]), xy divided by w."""
    eye = jnp.asarray(cam.position, jnp.float32)
    fwd = view_direction(cam.look_x, cam.look_y)
    view = look_at(eye, eye + fwd, jnp.asarray(cam.up, jnp.float32))
    proj = perspective(cam.fov_degrees, width / height)
    return proj, view


def project_to_screen(proj, view, p, width: int, height: int):
    """World point [..., 3] -> continuous screen (x, y) in pixels, GL
    y-up (the tracer's py convention)."""
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    q = ph @ view.T @ proj.T
    ndc = q[..., :2] / q[..., 3:4]
    x = (ndc[..., 0] * 0.5 + 0.5) * width
    y = (ndc[..., 1] * 0.5 + 0.5) * height
    return jnp.stack([x, y], axis=-1)


def silhouette_points(center, radius, eye, phis):
    """Stratified points on the sphere's tangency circle, differentiable
    w.r.t. (center, radius)."""
    d = center - eye
    L2 = jnp.sum(d * d)
    L = jnp.sqrt(L2)
    chat = d / L
    # basis perpendicular to the view axis
    helper = jnp.where(jnp.abs(chat[1]) < 0.9,
                       jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                       jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
    e1 = jnp.cross(chat, helper)
    e1 = e1 / jnp.linalg.norm(e1)
    e2 = jnp.cross(chat, e1)
    m = center - (radius * radius / L) * chat
    rho = radius * jnp.sqrt(jnp.maximum(1.0 - (radius / L) ** 2, 1e-12))
    circ = (m[None, :] + rho * (jnp.cos(phis)[:, None] * e1[None, :]
                                + jnp.sin(phis)[:, None] * e2[None, :]))
    return circ


def _radiance(trace_fn, o, d, seed, ray_depth: int, env_faces,
              russian_roulette: bool = False):
    """Radiance along explicit rays (Vec3 of [M] arrays) — the bounce loop
    + deferred env term, on the oracle trace.  Returns f32[3, M]."""
    zero = o[0] * 0.0
    zero3 = Vec3(zero, zero, zero)
    state = PathState(origin=o, direction=d, throughput=zero3 + 1.0,
                      radiance=zero3, seed=seed,
                      alive=jnp.zeros_like(seed, jnp.int32) + 1,
                      miss_dir=zero3, miss_thr=zero3,
                      ray_count=jnp.zeros_like(seed, jnp.int32))
    for _ in range(ray_depth):
        state = bounce_step(state, trace_fn, russian_roulette)
    env = sample_environment_planar(env_faces, state.miss_dir)
    return stack3(state.radiance) + stack3(state.miss_thr) * env


@partial(jax.jit, static_argnames=("cam", "width", "height", "ray_depth",
                                   "n_edge", "counts", "sphere_idx",
                                   "eps_px"))
def sphere_silhouette_grad(scene, cam: CameraConfig, env_faces,
                           rendered, target, frame, *, sphere_idx: int,
                           width: int, height: int, ray_depth: int = 6,
                           n_edge: int = 512,
                           counts: Tuple[int, int] | None = None,
                           eps_px: float = 0.35):
    """Boundary term of the pixel-MSE loss w.r.t. sphere ``sphere_idx``'s
    (center xyz, radius).

    ``rendered``/``target``: f32[H, W, 3] current render and target (GL
    row order) — the loss whose boundary term is estimated is
    ``mean((rendered - target)^2)``.  Returns (d_center f32[3], d_radius
    f32[]).  Add to the interior gradients from the differentiable
    renderer to get the full geometry gradient.
    """
    proj, view = forward_matrices(cam, width, height)
    inv_p, inv_v, _pos = camera_matrices(cam, width, height)
    eye = jnp.asarray(cam.position, jnp.float32)
    spr = scene.sphere_pos_radius[sphere_idx]
    phis = (jnp.arange(n_edge, dtype=jnp.float32) + 0.5) \
        * (2.0 * np.float32(np.pi) / n_edge)

    def screen_of(params, phi):
        center, radius = params[:3], params[3]
        p = silhouette_points(center, radius, eye, phi)
        return project_to_screen(proj, view, p, width, height)

    params = spr  # [4] = center xyz, radius
    xy = screen_of(params, phis)                       # [M, 2]
    # d screen / d (cx, cy, cz, r): [M, 2, 4]
    vel = jax.jacfwd(lambda th: screen_of(th, phis))(params)
    # screen tangent along the curve: d screen_j / d phi_j touches only
    # sample j, so one jvp with a ones tangent reads the diagonal
    _, tang = jax.jvp(lambda ph: screen_of(params, ph), (phis,),
                      (jnp.ones_like(phis),))          # [M, 2]
    dsigma = jnp.linalg.norm(tang, axis=-1) * (2.0 * np.float32(np.pi)
                                               / n_edge)
    normal = jnp.stack([tang[:, 1], -tang[:, 0]], axis=-1)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)
    # orient outward: away from the projected sphere center
    c_scr = project_to_screen(proj, view, spr[None, :3], width, height)[0]
    outward = jnp.sum((xy - c_scr[None, :]) * normal, axis=-1) >= 0
    normal = jnp.where(outward[:, None], normal, -normal)

    # f_in / f_out: eye rays through screen points eps inside/outside.
    # primary_ray with zero draws and fpx = screen x gives the exact
    # pinhole ray through the continuous screen position (corner-jitter
    # NDC arithmetic with jitter 0).
    cpar = camera_params(inv_p, inv_v, jnp.float32(cam.focal_length),
                         jnp.float32(0.0))
    trace = compose_trace_fn(make_scene_scan_fn(scene, counts=counts),
                             make_xla_gather_fn(scene))

    def rad_at(pts):
        zero = pts[:, 0] * 0.0  # lane-shaped: primary_ray broadcasts draws
        o, d = primary_ray(cpar, pts[:, 0], pts[:, 1], width, height,
                           (zero, zero, zero, zero))
        seed = rng.pixel_seed(
            jnp.arange(n_edge, dtype=jnp.int32), jnp.int32(9173),
            jnp.asarray(frame, jnp.int32))
        _draws, seed = sample_draws(seed)  # decorrelate from pixel streams
        return _radiance(trace, o, d, seed, ray_depth, env_faces)

    f_in = rad_at(xy - eps_px * normal)                # [3, M]
    f_out = rad_at(xy + eps_px * normal)

    # loss derivative at the edge pixels: l' = 2 (I - T) / (H W 3)
    ix = jnp.clip(xy[:, 0].astype(jnp.int32), 0, width - 1)
    iy = jnp.clip(xy[:, 1].astype(jnp.int32), 0, height - 1)
    lprime = 2.0 * (rendered[iy, ix] - target[iy, ix]) \
        / np.float32(height * width * 3)               # [M, 3]
    # zero contribution from edge samples projecting off-screen
    on_screen = ((xy[:, 0] >= 0) & (xy[:, 0] < width)
                 & (xy[:, 1] >= 0) & (xy[:, 1] < height))

    strength = jnp.sum(lprime.T * (f_in - f_out), axis=0)  # [M]
    strength = jnp.where(on_screen, strength, 0.0)
    nv = jnp.einsum("mk,mkp->mp", normal, vel)         # [M, 4]
    g = jnp.sum((strength * dsigma)[:, None] * nv, axis=0)
    return g[:3], g[3]


@partial(jax.jit, static_argnames=("cam", "sphere_indices", "width",
                                   "height", "ray_depth", "counts",
                                   "n_edge", "eps_px", "interior"))
def _geometry_grad(scene, cam: CameraConfig, env_faces, rendered, target,
                   frame, sphere_indices: Tuple[int, ...], *, width: int,
                   height: int, ray_depth: int = 6,
                   counts: Tuple[int, int] | None = None,
                   n_edge: int = 512, eps_px: float = 0.35,
                   interior: bool = True):
    from .integrator import apply_environment, trace_paths

    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    cpar = camera_params(inv_p, inv_v, jnp.float32(cam.focal_length),
                         jnp.float32(cam.aperture_diameter))

    def interior_loss(spr):
        s = dataclasses.replace(scene, sphere_pos_radius=spr)
        trace = compose_trace_fn(make_scene_scan_fn(s, counts=counts),
                                 make_xla_gather_fn(s))
        py = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
        px = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
        res = trace_paths(trace, cpar, px, py, width, height,
                          jnp.asarray(frame, jnp.int32), ray_depth, 1,
                          russian_roulette=False)
        img = jnp.moveaxis(apply_environment(res, env_faces, 1), 0, -1)
        return jnp.mean((img - target) ** 2)

    if interior:
        g = jax.grad(interior_loss)(scene.sphere_pos_radius)
    else:
        # boundary-only mode: in multi-bounce specular scenes the interior
        # geometry term is noise- AND bias-dominated (measured on the demo
        # scene: per-frame std ~40x the boundary signal, plus a systematic
        # radius-inflation bias — the r4 pathology), while the boundary
        # term stays correctly signed on every axis.  Position recovery
        # there uses the silhouette alone.
        g = jnp.zeros_like(scene.sphere_pos_radius)
    mask = jnp.zeros((scene.sphere_pos_radius.shape[0], 1), jnp.float32)
    for i in sphere_indices:
        mask = mask.at[i].set(1.0)
        d_c, d_r = sphere_silhouette_grad(
            scene, cam, env_faces, rendered, target, frame, sphere_idx=i,
            width=width, height=height, ray_depth=ray_depth, counts=counts,
            n_edge=n_edge, eps_px=eps_px)
        g = g.at[i, :3].add(d_c).at[i, 3].add(d_r)
    # finite filter: grazing intersections have infinite partials (sqrt at
    # disc == 0); a lane landing exactly there poisons the whole reduce.
    # Zeroing the measure-zero event is the same policy as
    # kernels.trace_grad's filter — the estimator is unchanged in
    # expectation.
    g = jnp.where(jnp.isfinite(g), g, 0.0)
    return g * mask


def geometry_grad(scene, cam: CameraConfig, env_faces, rendered, target,
                  frame, sphere_indices, **kw):
    """Interior + boundary geometry gradient for the listed spheres.

    Interior term: reverse-mode AD of the pixel-MSE through the oracle
    renderer w.r.t. sphere_pos_radius (detached decisions).  Boundary
    term: :func:`sphere_silhouette_grad` per sphere.  Returns
    d_sphere_pos_radius f32[Ns, 4] with rows outside ``sphere_indices``
    zeroed.  Jitted (one program per static config); ``sphere_indices``
    may be any iterable of ints."""
    return _geometry_grad(scene, cam, env_faces, rendered, target,
                          jnp.asarray(frame, jnp.int32),
                          tuple(int(i) for i in sphere_indices), **kw)
