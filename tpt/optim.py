"""Inverse-rendering optimization — the library home of the recipe that
converges (distilled from r4's benchmarks/inverse_demo.py).

The reference app has no training loop at all (SURVEY §2.3: single GPU,
forward only); this module is the from-scratch differentiable story's
optimizer layer.  Three hard-won defaults are baked in:

* **Fixed-depth transport** (``russian_roulette=False``): Russian roulette
  divides a surviving path's throughput by its max channel, so RR'd pixel
  values depend only on albedo RATIOS — no pixel-loss estimator can
  recover the albedo scale through it (tpt.integrator.bounce_step).  The
  RR roll is still drawn, keeping the RNG stream aligned with the forward
  renderer.
* **Global-norm-clipped Adam**: per-parameter scaling absorbs the
  orders-of-magnitude spread between albedo and emissive gradients, and
  clipping tames firefly frames (fixed-depth transport weights a
  low-probability Fresnel lobe pick by an unclamped 1/p — huge but
  correctly-signed gradients).
* **Constant-then-cosine schedule**: constant lr for the first 60% of the
  budget, cosine decay to ~1% after — the final MAE floor tracks
  lr x gradient noise.

Plus optimizer-state checkpoint/resume (SURVEY §5 calls for it; the
reference persists nothing but screenshots).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from .camera import camera_matrices
from .config import CameraConfig


def default_schedule(lr: float, total_steps: int):
    """Constant for the first 60% of ``total_steps``, cosine decay to 1%."""
    return optax.join_schedules(
        [optax.constant_schedule(lr),
         optax.cosine_decay_schedule(lr, max(total_steps * 2 // 5, 1), 0.01)],
        [max(total_steps * 3 // 5, 1)])


def clipped_adam(lr: float = 5e-3, total_steps: Optional[int] = None,
                 clip_norm: float = 1.0) -> optax.GradientTransformation:
    """The training default: global-norm clip -> Adam (-> schedule)."""
    sched = default_schedule(lr, total_steps) if total_steps else lr
    return optax.chain(optax.clip_by_global_norm(clip_norm),
                       optax.adam(sched))


def make_renderer(scene, views: Sequence[CameraConfig], *, width: int,
                  height: int, ray_depth: int, spp: int,
                  counts: Tuple[int, int], env_table,
                  jitter: str = "corner", russian_roulette: bool = False):
    """Differentiable single-chip renderer over a set of camera views.

    Returns ``render(sphere_mat, cuboid_mat, frame, view) -> f32[H, W, 3]``
    on the production differentiable path (Pallas forward + XLA
    reverse mode, tpt.kernels.trace_grad).  ``view`` is a static index
    into ``views``; multiple views solve identifiability (a parameter no
    light path observes cannot be recovered by any estimator).
    """
    from .integrator import apply_environment_blocked
    from .kernels.trace_grad import trace_diff

    mats = []
    for c in views:
        inv_p, inv_v, _ = camera_matrices(c, width, height)
        mats.append((inv_p, inv_v, jnp.float32(c.focal_length),
                     jnp.float32(c.aperture_diameter)))

    def render(sphere_mat, cuboid_mat, frame, view: int):
        inv_p, inv_v, focal, aperture = mats[view]
        s = dataclasses.replace(scene, sphere_material=sphere_mat,
                                cuboid_material=cuboid_mat)
        res = trace_diff(s, inv_p, inv_v, frame, focal, aperture,
                         jnp.int32(0), width, height, ray_depth, spp,
                         counts, None, jitter, russian_roulette)
        return jnp.moveaxis(apply_environment_blocked(res, env_table, spp),
                            0, -1)

    return render


def make_inverse_step(render, optimizer: optax.GradientTransformation,
                      n_views: int, grad_frames: int = 1, param_mask=None):
    """Jitted optimization step for material-table recovery.

    ``step(params, opt_state, frame, targets) -> (params, opt_state, loss)``
    where ``params = (sphere_material, cuboid_material)`` and ``targets``
    is ``f32[grad_frames, n_views, H, W, 3]``.  The loss is the pixel MSE
    averaged over all views and ``grad_frames`` independent RNG streams
    (each a fresh Monte-Carlo draw, so gradient noise drops ~1/sqrt(F));
    ``param_mask`` freezes masked-out entries.
    """

    @jax.jit
    def step(params, opt_state, frame, targets):
        def loss_fn(p):
            total = jnp.float32(0.0)
            for f in range(grad_frames):
                for v in range(n_views):
                    img = render(p[0], p[1], frame * grad_frames + f, v)
                    err = img - targets[f, v]
                    total = total + jnp.mean(err * err)
            return total / (grad_frames * n_views)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        if param_mask is not None:
            grads = tuple(g * m for g, m in zip(grads, param_mask))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def save_optim_checkpoint(path: str, params, opt_state, step: int):
    """Persist (params, optimizer state, step counter) to one npz file.

    The state pytree is flattened leaf-by-leaf; :func:`load_optim_checkpoint`
    rebuilds the structure from ``optimizer.init`` on matching params, so
    the file stays a plain array container (no pickled code).
    """
    leaves = jax.tree_util.tree_leaves((params, opt_state))
    np.savez(path, step=np.int64(step), n_leaves=np.int64(len(leaves)),
             **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})


def load_optim_checkpoint(path: str, optimizer: optax.GradientTransformation,
                          example_params):
    """Restore (params, opt_state, step) written by save_optim_checkpoint.

    ``example_params`` must match the saved params in structure/shape (it
    seeds the pytree structure via ``optimizer.init``)."""
    data = np.load(path)
    n = int(data["n_leaves"])
    leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n)]
    treedef = jax.tree_util.tree_structure(
        (example_params, optimizer.init(example_params)))
    params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    return params, opt_state, int(data["step"])
