"""Differentiable production trace: kernel forward, XLA reverse-mode backward.

``trace_diff`` returns the Pallas trace kernel's TraceResult (tpt.kernels.
trace) and is reverse-mode differentiable w.r.t. the scene's float leaves,
the inverse projection/view matrices, focal length and aperture.  Its
backward is ``jax.vjp`` through the XLA oracle trace of the same pixels
(tpt.integrator.trace_paths at static primitive counts) with per-bounce
rematerialization (``loop="remat"``): reverse mode stores only each
bounce's input carry and recomputes the bounce's internals.  The kernel and
the oracle share the integrator source, so the backward linearizes the
function the forward computed.

The environment term stays OUTSIDE: callers differentiate through
apply_environment_blocked in XLA (gather transpose = scatter-add), which
yields the cubemap cotangent; ``trace_diff``'s backward receives the
resulting (d radiance, d miss_dir, d miss_thr) cotangents per pixel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..integrator import (camera_params, compose_trace_fn,
                          make_scene_scan_fn, make_xla_gather_fn, trace_paths)


def _oracle_band(scene, inv_proj, inv_view, frame, focal_length,
                 aperture_diameter, row0, width, height, ray_depth, spp,
                 counts, n_rows, jitter, rr):
    """The oracle trace of the pixel band the kernel traced: the
    differentiable outputs (radiance, miss_dir, miss_thr)."""
    py = row0 + jax.lax.broadcasted_iota(jnp.int32, (n_rows, width), 0)
    py = jnp.minimum(py, height - 1)
    px = jax.lax.broadcasted_iota(jnp.int32, (n_rows, width), 1)
    trace = compose_trace_fn(make_scene_scan_fn(scene, counts=counts),
                             make_xla_gather_fn(scene))
    cam = camera_params(inv_proj, inv_view, focal_length, aperture_diameter)
    res = trace_paths(trace, cam, px, py, width, height, frame, ray_depth,
                      spp, loop="remat", jitter=jitter, russian_roulette=rr)
    return res.radiance, res.miss_dir, res.miss_thr


def _finite(tree):
    """Zero non-finite cotangent entries.  Rare degenerate lane
    configurations (grazing hits, axis-parallel slabs) can emit a
    non-finite partial, and a gather's transpose then sums it into a
    whole table entry; dropping that measure-zero set is the standard
    differentiable-rendering treatment (the estimator is already biased at
    decision boundaries) and changes nothing in expectation."""
    return jax.tree_util.tree_map(
        lambda g: jnp.where(jnp.isfinite(g), g, 0.0)
        if jnp.issubdtype(g.dtype, jnp.floating) else g, tree)


@functools.partial(jax.custom_vjp,
                   nondiff_argnums=(7, 8, 9, 10, 11, 12, 13, 14))
def trace_diff(scene, inv_proj, inv_view, frame, focal_length,
               aperture_diameter, row0, width: int, height: int,
               ray_depth: int, spp: int, counts: Tuple[int, int],
               n_rows: int | None = None,
               jitter: str = "corner", rr: bool = True):
    """Differentiable production trace: kernel forward, XLA backward.

    Returns pallas_trace's TraceResult.  Compose with
    tpt.integrator.apply_environment_blocked for a fully differentiable
    frame.  ``row0``/``n_rows`` select a pixel-row band (the sharded
    training path); row0 is a traced int with zero cotangent.  ``counts``
    must be static: reverse mode cannot transpose loops with traced trip
    counts."""
    from .trace import pallas_trace
    return pallas_trace(scene, inv_proj, inv_view, frame, focal_length,
                        aperture_diameter, width=width, height=height,
                        ray_depth=ray_depth, spp=spp, counts=counts,
                        n_rows=n_rows, row0=row0, jitter=jitter, rr=rr)


def _trace_diff_fwd(scene, inv_proj, inv_view, frame, focal_length,
                    aperture_diameter, row0, width, height, ray_depth, spp,
                    counts, n_rows=None, jitter="corner", rr=True):
    out = trace_diff(scene, inv_proj, inv_view, frame, focal_length,
                     aperture_diameter, row0, width, height, ray_depth, spp,
                     counts, n_rows, jitter, rr)
    return out, (scene, inv_proj, inv_view, frame, focal_length,
                 aperture_diameter, row0)


def _trace_diff_bwd(width, height, ray_depth, spp, counts, n_rows, jitter,
                    rr, residuals, ct):
    if counts is None:
        raise ValueError("trace_diff's backward requires static counts")
    scene, inv_proj, inv_view, frame, focal, aperture, row0 = residuals
    n_rows = height if n_rows is None else n_rows
    _, vjp = jax.vjp(
        lambda s, ip, iv, f, a: _oracle_band(
            s, ip, iv, frame, f, a, row0, width, height, ray_depth, spp,
            counts, n_rows, jitter, rr),
        scene, inv_proj, inv_view, focal, aperture)
    d_scene, d_ip, d_iv, d_focal, d_ap = _finite(
        vjp((ct.radiance, ct.miss_dir, ct.miss_thr)))
    d_frame = np.zeros(np.shape(frame), jax.dtypes.float0)
    d_row0 = np.zeros(np.shape(row0), jax.dtypes.float0)
    return d_scene, d_ip, d_iv, d_frame, d_focal, d_ap, d_row0


trace_diff.defvjp(_trace_diff_fwd, _trace_diff_bwd)
