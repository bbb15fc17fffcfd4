"""Geometry recovery via silhouette-aware gradients — the capability r4
declared out of scope by estimator design.

A sphere's position AND radius are perturbed and recovered by Adam on the
pixel-MSE, using tpt.silhouette.geometry_grad = interior (detached-
decision AD) + boundary (edge-sampling) terms.  Interior-only gradients
provably cannot do this (r4 probes: radius inflates, position stalls —
PERF.md); with the boundary term both parameters descend to the target.

Usage: python benchmarks/silhouette_demo.py [--steps N] [--size N]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--scene", default="single", choices=["single", "demo"],
                    help="'single' = isolated sphere vs constant env; "
                         "'demo' = a 6x6-grid sphere inside the FULL "
                         "48-sphere/7-cuboid demo scene (occlusion, "
                         "textured background, secondary bounces)")
    ap.add_argument("--out", default="results/silhouette_demo.json")
    args = ap.parse_args()
    if args.scene == "demo":
        return run_demo_scene(args)

    import dataclasses
    import jax
    import jax.numpy as jnp
    import optax
    from tpt.utils import enable_persistent_cache
    enable_persistent_cache()
    from tpt import camera
    from tpt.config import CameraConfig
    from tpt.env import constant_environment
    from tpt.integrator import (apply_environment, camera_params,
                                compose_trace_fn, make_scene_scan_fn,
                                make_xla_gather_fn, trace_paths)
    from tpt.materials import Material
    from tpt.scene import SceneBuilder
    from tpt.silhouette import geometry_grad

    W = H = args.size
    DEPTH = 2
    CAM = CameraConfig(position=(0.0, 0.0, 6.0), look_x=-90.0, look_y=0.0,
                       focal_length=8.0, aperture_diameter=0.0)
    ENV = constant_environment((0.15, 0.2, 0.3))
    TRUE_C, TRUE_R = (0.25, 0.1, 0.0), 1.05
    START_C, START_R = (-0.15, -0.35, 0.3), 1.3

    def build(center, radius):
        b = SceneBuilder()
        b.add_sphere(tuple(map(float, center)), float(radius), Material.make(
            (0.85, 0.3, 0.2), (0, 0, 0), (0, 0, 0), 0.0, 0.0, 1.0, 0.0, 0.0))
        return b.build()

    @jax.jit
    def render(scene, frame):
        inv_p, inv_v, _ = camera.camera_matrices(CAM, W, H)
        cpar = camera_params(inv_p, inv_v, jnp.float32(CAM.focal_length),
                             jnp.float32(0.0))
        trace = compose_trace_fn(make_scene_scan_fn(scene, counts=(1, 0)),
                                 make_xla_gather_fn(scene))
        py = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        px = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        res = trace_paths(trace, cpar, px, py, W, H, frame, DEPTH, 1,
                          russian_roulette=False)
        return jnp.moveaxis(apply_environment(res, ENV, 1), 0, -1)

    target = render(build(TRUE_C, TRUE_R), jnp.int32(0))
    scene = build(START_C, START_R)
    spr = scene.sphere_pos_radius

    opt = optax.adam(args.lr)
    state = opt.init(spr)
    pos_err0 = float(np.linalg.norm(np.asarray(spr[0, :3])
                                    - np.asarray(TRUE_C)))
    rad_err0 = abs(float(spr[0, 3]) - TRUE_R)

    t0 = time.time()
    for i in range(args.steps):
        s = dataclasses.replace(scene, sphere_pos_radius=spr)
        rendered = render(s, jnp.int32(i))
        g = geometry_grad(s, CAM, ENV, rendered, target, i, [0],
                          width=W, height=H, ray_depth=DEPTH,
                          counts=(1, 0), n_edge=1024)
        updates, state = opt.update(g, state, spr)
        spr = optax.apply_updates(spr, updates)
        if i % 25 == 0 or i == args.steps - 1:
            pe = float(np.linalg.norm(np.asarray(spr[0, :3])
                                      - np.asarray(TRUE_C)))
            re = abs(float(spr[0, 3]) - TRUE_R)
            print(f"step {i:4d}  pos_err {pe:.4f}  rad_err {re:.4f}",
                  flush=True)

    pos_err = float(np.linalg.norm(np.asarray(spr[0, :3])
                                   - np.asarray(TRUE_C)))
    rad_err = abs(float(spr[0, 3]) - TRUE_R)
    result = {
        "metric": "silhouette_geometry_recovery",
        "steps": args.steps, "size": args.size,
        "wall_s": round(time.time() - t0, 1),
        "pos_err_before": round(pos_err0, 4),
        "pos_err_after": round(pos_err, 4),
        "radius_err_before": round(rad_err0, 4),
        "radius_err_after": round(rad_err, 4),
    }
    print(json.dumps(result))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    # recovery = the errors DECREASED by an order of magnitude
    assert pos_err < pos_err0 * 0.15, (pos_err, pos_err0)
    assert rad_err < rad_err0 * 0.15, (rad_err, rad_err0)
    return 0


def run_demo_scene(args) -> int:
    """Recover a 6x6-grid sphere's position inside the FULL demo scene:
    the silhouette lands on the green wall and neighbouring spheres, the
    interior term is live (varying lighting/specular), and the boundary
    estimator's implicit occlusion handling is exercised for real."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import optax
    from tpt.utils import enable_persistent_cache
    enable_persistent_cache()
    from tpt import camera, demo_scene
    from tpt.config import CameraConfig
    from tpt.env import constant_environment
    from tpt.integrator import (apply_environment, camera_params,
                                compose_trace_fn, make_scene_scan_fn,
                                make_xla_gather_fn, trace_paths)
    from tpt.silhouette import geometry_grad

    W = H = max(args.size, 128)
    DEPTH, COUNTS, IDX = 3, (48, 7), 14   # grid sphere (x=2, y=2)
    CAM = CameraConfig(position=(-1.0, -0.8, -21.0), look_x=90.0,
                       look_y=0.0, aperture_diameter=0.0)
    ENV = constant_environment((0.7, 0.8, 1.0))

    @jax.jit
    def render(scene, frame):
        inv_p, inv_v, _ = camera.camera_matrices(CAM, W, H)
        cpar = camera_params(inv_p, inv_v, jnp.float32(CAM.focal_length),
                             jnp.float32(0.0))
        trace = compose_trace_fn(make_scene_scan_fn(scene, counts=COUNTS),
                                 make_xla_gather_fn(scene))
        py = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        px = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        res = trace_paths(trace, cpar, px, py, W, H, frame, DEPTH, 1,
                          russian_roulette=False)
        return jnp.moveaxis(apply_environment(res, ENV, 1), 0, -1)

    true_scene = demo_scene().build()
    true_pos = np.asarray(true_scene.sphere_pos_radius[IDX, :3])

    spr = true_scene.sphere_pos_radius.at[IDX, :3].add(
        jnp.asarray([0.8, -0.6, 0.0]))
    scene = dataclasses.replace(true_scene, sphere_pos_radius=spr)
    pos_err0 = float(np.linalg.norm(np.asarray(spr[IDX, :3]) - true_pos))

    # clipped Adam: fixed-depth transport fireflies give huge but
    # correctly-signed gradient frames (tpt.optim rationale)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(args.lr * 2.0))
    state = opt.init(spr)
    t0 = time.time()
    for i in range(args.steps):
        s = dataclasses.replace(scene, sphere_pos_radius=spr)
        rendered = render(s, jnp.int32(i))
        # matched-seed target (the inverse_demo discipline): rendering the
        # TRUE scene with the SAME frame makes the residual purely
        # parameter-driven — at the optimum the loss is exactly zero, and
        # the loss-derivative factor of the boundary term is clean signal
        # instead of MC noise
        target = render(true_scene, jnp.int32(i))
        # boundary-only gradients, position axes only: the interior term
        # is noise/bias-dominated in this multi-bounce specular scene
        # (tpt.silhouette._geometry_grad docstring; measured 16-frame
        # stats in PERF.md r5) and the radius is not perturbed here
        g = geometry_grad(s, CAM, ENV, rendered, target, i, [IDX],
                          width=W, height=H, ray_depth=DEPTH,
                          counts=COUNTS, n_edge=2048, interior=False)
        g = g.at[IDX, 3].set(0.0)
        updates, state = opt.update(g, state, spr)
        spr = optax.apply_updates(spr, updates)
        if i % 25 == 0 or i == args.steps - 1:
            pe = float(np.linalg.norm(np.asarray(spr[IDX, :3]) - true_pos))
            print(f"step {i:4d}  pos_err {pe:.4f}", flush=True)

    pos_err = float(np.linalg.norm(np.asarray(spr[IDX, :3]) - true_pos))
    rad_err = abs(float(spr[IDX, 3])
                  - float(true_scene.sphere_pos_radius[IDX, 3]))
    result = {
        "metric": "silhouette_geometry_recovery_demo_scene",
        "steps": args.steps, "size": W, "sphere": IDX,
        "wall_s": round(time.time() - t0, 1),
        "pos_err_before": round(pos_err0, 4),
        "pos_err_after": round(pos_err, 4),
        "radius_err_after": round(rad_err, 4),
    }
    print(json.dumps(result))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    assert pos_err < pos_err0 * 0.25, (pos_err, pos_err0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
