"""Inverse-rendering step benchmark at 1080p (BASELINE config 5 scale).

Times one full gradient step (forward + backward + SGD update on the
material tables, clipped Adam) of a pixel-MSE loss on the demo scene
through tpt.parallel.make_train_step on one card, counts (48, 7),
fixed-depth transport (russian_roulette=False, the inverse-rendering
setting):

  kernel : Pallas trace kernel forward + XLA reverse mode through the
           oracle with per-bounce remat (tpt.kernels.trace_grad)
  oracle : XLA integrator forward + the same reverse mode

Prints ms/step, the compiled step's memory_analysis() and the peak device
memory, beside the card's name and power limit.

Usage: python benchmarks/train_bench.py [kernel|oracle] [--size WxH]
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("backend", nargs="?", default="kernel",
                    choices=["kernel", "oracle"])
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    width, height = map(int, args.size.split("x"))

    import jax.numpy as jnp
    from tpt.utils import enable_persistent_cache
    from tpt.utils.profiling import card_line, require_gpu
    dev = require_gpu("train_bench")
    enable_persistent_cache()
    from tpt import CameraConfig, demo_scene
    from tpt.camera import camera_matrices
    from tpt.config import RenderConfig
    from tpt.env import constant_environment
    from tpt.optim import clipped_adam
    from tpt.parallel import make_mesh, make_train_step

    cam = CameraConfig()
    scene = demo_scene().build()
    inv_p, inv_v, _ = camera_matrices(cam, width, height)
    env = constant_environment((0.7, 0.8, 1.0))
    target = jnp.zeros((height, width, 3), jnp.float32) + 0.25
    cfg = RenderConfig(width=width, height=height, ray_depth=13, spp=1)
    opt = clipped_adam()
    step = make_train_step(make_mesh(1, 1, devices=[dev]), cfg,
                           counts=(48, 7), backend=args.backend,
                           russian_roulette=False, optimizer=opt)
    state = opt.init((scene.sphere_material, scene.cuboid_material))
    step_args = lambda s, f, o: (s, env, inv_p, inv_v, cam.focal_length,
                                 cam.aperture_diameter, f, target, o)

    t0 = time.perf_counter()
    compiled = step.lower(*step_args(scene, 0, state)).compile()
    print(f"compile: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"memory_analysis: {compiled.memory_analysis()}", flush=True)
    ts = []
    for i in range(args.steps + 1):
        t0 = time.perf_counter()
        scene, state, loss = step(*step_args(scene, i, state))
        loss = float(loss)               # fetching syncs the device
        ts.append(time.perf_counter() - t0)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30
    print(f"{args.backend} step {args.size}: {np.median(ts[1:]) * 1e3:.1f} "
          f"ms/step, loss {loss:.6f}, peak device memory {peak:.2f} GiB  "
          f"[{card_line()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
