"""Scaling harness: the sharded renderer at dp = 1, 2, 4, ... cards.

Runs the production sharded renderer (Pallas kernel backend,
tpt.parallel.make_dist_renderer) on the first dp cards of the machine and
reports parallel efficiency = T(1) / (dp * T(dp)), beside the card's name
and power limit.  The sharded program itself is checked on the CPU by
tests/test_dist.py on virtual devices; this script only times it.

Usage: python benchmarks/scaling.py [--width W] [--height H] [--depth D]
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=13)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    from tpt.utils import enable_persistent_cache
    from tpt.utils.profiling import card_line, require_gpu
    require_gpu("scaling")
    enable_persistent_cache()
    from tpt import CameraConfig, RenderConfig, demo_scene
    from tpt.camera import camera_matrices
    from tpt.env import constant_environment
    from tpt.parallel import make_dist_renderer, make_mesh

    n_dev = len(jax.devices())
    cam = CameraConfig()
    cfg = RenderConfig(width=args.width, height=args.height,
                       ray_depth=args.depth, spp=1, static_counts=(48, 7))
    scene = demo_scene().build()
    inv_p, inv_v, _ = camera_matrices(cam, cfg.width, cfg.height)
    env = constant_environment((0.7, 0.8, 1.0))

    results = []
    t1 = None
    dp = 1
    while dp <= n_dev:
        mesh = make_mesh(dp=dp, sp=1, devices=jax.devices()[:dp])
        render = make_dist_renderer(mesh, cfg)
        jax.block_until_ready(render(scene, env, inv_p, inv_v,
                                     cam.focal_length,
                                     cam.aperture_diameter, 0))
        ts = []
        for i in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(render(scene, env, inv_p, inv_v,
                                         cam.focal_length,
                                         cam.aperture_diameter, i + 1))
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts))
        t1 = t if t1 is None else t1
        results.append({"dp": dp, "ms": t * 1e3,
                        "efficiency": t1 / (dp * t)})
        print(f"dp={dp:2d}: {t * 1e3:9.3f} ms  efficiency "
              f"{t1 / (dp * t):6.1%}", flush=True)
        dp *= 2

    print(json.dumps({"metric": "dp_scaling", "card": card_line(),
                      "n_devices": n_dev,
                      "config": {"width": args.width, "height": args.height,
                                 "ray_depth": args.depth, "spp": 1},
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
