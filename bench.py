"""Benchmark: demo scene at 1080p on one GPU, Pallas kernel path.

Prints the device line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.
The metric is Mrays/s per card — traced path segments (counted in-kernel,
so Russian-roulette termination is reflected) per wall second,
steady-state.  Baseline target from BASELINE.md: 100 Mrays/s.

Workload = the reference's default frame loop: progressive accumulation of
the 48-sphere/7-cuboid demo scene (src/MainWindow.cs:208-267) under the
precomputed 256^2 atmospheric-scattering skybox (the reference default,
src/MainWindow.cs:174), ray depth 13, spp 1, thin-lens DoF.  Frames are
rendered in fused blocks of CHUNK (trace kernel -> one-row-gather env fetch
-> donated running-mean accumulate in ONE device program) exactly as the
interactive/CLI paths do; timing syncs once per block.

Exits non-zero without printing a result when JAX finds no GPU.
"""

import json
import sys
import time

import numpy as np

CHUNK = 30  # frames per fused block: one host sync per block


def main() -> int:
    import jax
    import jax.numpy as jnp
    from tpt.utils import enable_persistent_cache
    from tpt.utils.profiling import card_line, require_gpu
    dev = require_gpu("bench")
    enable_persistent_cache()
    from tpt import CameraConfig, demo_scene
    from tpt.camera import camera_matrices
    from tpt.config import AtmosphereConfig
    from tpt.env import pack_block_table
    from tpt.kernels.render import progressive_frames
    from tpt.progressive import init_accumulator
    from tpt.sky import compute_atmosphere

    width, height = 1920, 1080
    ray_depth, spp = 13, 1
    cam = CameraConfig()
    scene = demo_scene().build()
    inv_proj, inv_view, _pos = camera_matrices(cam, width, height)
    env_table = pack_block_table(compute_atmosphere(AtmosphereConfig()))
    focal = jnp.float32(cam.focal_length)
    aperture = jnp.float32(cam.aperture_diameter)

    def block(accum, frame0):
        return progressive_frames(
            accum, scene, env_table, inv_proj, inv_view, jnp.int32(frame0),
            focal, aperture, width=width, height=height, ray_depth=ray_depth,
            spp=spp, counts=(48, 7), n_frames=CHUNK)

    accum = init_accumulator(height, width)
    for i in range(2):  # compile + warm
        accum, rays = block(accum, i * CHUNK)
        jax.block_until_ready(accum.image)

    times, ray_counts = [], []
    for i in range(2, 8):
        t0 = time.perf_counter()
        accum, rays = block(accum, i * CHUNK)
        ray_counts.append(int(rays))  # fetching syncs the device
        times.append(time.perf_counter() - t0)

    med = float(np.median(times))
    mrays = float(np.mean(ray_counts)) / med / 1e6
    print(f"card: {card_line()}")
    print(json.dumps({
        "metric": "demo_scene_1080p_mrays_per_sec_per_card",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / 100.0,
        "ms_per_frame": med / CHUNK * 1e3,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
