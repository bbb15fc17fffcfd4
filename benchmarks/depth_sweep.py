"""Frame cost vs ray depth at 1080p: per-frame kernel vs path regeneration.

Both run the production progressive block (tpt.kernels.render.
progressive_frames: trace kernel -> env fetch -> accumulate, 30 frames per
block) on the demo scene, spp 1, 256^2 atmosphere:

  per-frame : lax.scan over per-frame launches of the trace kernel; each
              pixel block's bounce loop runs until its last lane dies, so
              Russian roulette's straggler tail is paid every frame;
  refill    : one launch of the path-regeneration kernel per block; a lane
              whose path ends starts its next frame's sample at once, so
              the tail is paid once per block.

Traced segments saturate with depth (RR keeps E[bounces] ~ 2.7); the
per-frame cost keeps growing with depth as long as the tail does, the
refill cost follows the segment count.

Usage: python benchmarks/depth_sweep.py [--depths 4,8,13,20]
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="4,8,13,20")
    ap.add_argument("--frames", type=int, default=30,
                    help="frames per fused block")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tpt.utils import enable_persistent_cache
    from tpt.utils.profiling import card_line, require_gpu
    require_gpu("depth_sweep")
    enable_persistent_cache()
    from tpt import CameraConfig, demo_scene
    from tpt.camera import camera_matrices
    from tpt.config import AtmosphereConfig
    from tpt.env import pack_block_table
    from tpt.kernels.render import progressive_frames
    from tpt.progressive import init_accumulator
    from tpt.sky import compute_atmosphere

    W, H, F = 1920, 1080, args.frames
    cam = CameraConfig()
    scene = demo_scene().build()
    inv_p, inv_v, _ = camera_matrices(cam, W, H)
    table = pack_block_table(compute_atmosphere(AtmosphereConfig()))
    card = card_line()

    for depth in map(int, args.depths.split(",")):
        for refill in (False, True):
            def block(acc, f0, depth=depth, refill=refill):
                return progressive_frames(
                    acc, scene, table, inv_p, inv_v, jnp.int32(f0),
                    jnp.float32(cam.focal_length),
                    jnp.float32(cam.aperture_diameter), width=W, height=H,
                    ray_depth=depth, spp=1, counts=(48, 7), n_frames=F,
                    refill=refill)

            acc = init_accumulator(H, W)
            acc, r = block(acc, 0)
            jax.block_until_ready(acc.image)
            ts, cs = [], []
            for i in range(4):
                t0 = time.perf_counter()
                acc, r = block(acc, (i + 1) * F)
                cs.append(int(r))        # fetching syncs the device
                ts.append(time.perf_counter() - t0)
            med = float(np.median(ts))
            name = "refill" if refill else "per-frame"
            print(f"depth {depth:2d} {name:9s}: {med / F * 1e3:7.3f} "
                  f"ms/frame  {np.mean(cs) / F / 1e6:5.2f}M segs/frame  "
                  f"{np.mean(cs) / med / 1e6:6.1f} Mrays/s  [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
