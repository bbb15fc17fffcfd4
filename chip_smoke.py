"""Proof that tpt runs on one NVIDIA GPU: kernels compiled, results right.

    python chip_smoke.py                  # every one-card phase
    python chip_smoke.py --phase golden   # one phase (device always runs)
    python chip_smoke.py --four-cards     # the sharded phase on 4 cards only
    python chip_smoke.py --profile DIR    # also trace one oracle frame and
                                          # one training step into DIR

Phases, each printing its result on its own line:

  device   the platform is ``gpu``; the Pallas kernels compile (the
           interpreter is off); the card's name and power limit.
  golden   the compiled trace kernel at 512^2, depth 13, 32^2 sky, counts
           (48, 7) against tests/golden/demo_512.npz.
  forward  1080p demo scene, depth 13, spp 1, 256^2 atmosphere: one kernel
           frame against the XLA oracle frame, then ms/frame and Mrays/s of
           progressive_frames in 30-frame blocks as bench.py runs it — the
           per-frame kernel and the path-regeneration kernel — and of the
           XLA oracle frame.
  train    a few 1080p make_train_step steps (counts (48, 7), fixed-depth
           transport, clipped Adam): finite loss, ms/step,
           memory_analysis(); material gradients of the kernel step against
           the XLA oracle step at 256^2.
  four     (only with --four-cards) dp=4 and dp=2 x sp=2 meshes at 1080p:
           sharded render and train-step gradients against one card.

Image comparisons use a chaos-aware gate: at least 99.9% of elements within
5e-3 + 2e-3 |ref| and mean |err| below 1e-3.  FMA contraction and the
transcendental implementations differ between the compiled kernel and the
reference, and a rounding difference can flip a Monte-Carlo decision (RR
survival, lobe pick, a near-tie closest hit) on a few pixels, changing
those pixels wholesale; a miscompile breaks far more.

Exits non-zero, printing no result line, when JAX finds no GPU.  The last
line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
RAY_DEPTH, SPP = 13, 1
COUNTS = (48, 7)
CHUNK = 30               # frames per fused block, as bench.py
GRAD_SIZE = 256          # gradient check resolution
PHASES = ("device", "golden", "forward", "train")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def image_gate(got, want, what: str):
    """Chaos-aware image comparison (module docstring); raises on failure."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    err = np.abs(got - want)
    frac = float((err > 5e-3 + 2e-3 * np.abs(want)).mean())
    mean = float(err.mean())
    ok = frac < 1e-3 and mean < 1e-3
    assert ok, f"{what}: {frac:.4%} elements off, mean |err| {mean:.2e}"
    return frac, mean


def timed(fn, n: int) -> float:
    """Median seconds of ``n`` synced calls (after one warm call)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def first_call(fn):
    """(result, seconds) of a first call: compile + one run."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def demo_setup(width: int, height: int, sky_size: int = 256):
    import jax.numpy as jnp
    from tpt import CameraConfig, demo_scene
    from tpt.camera import camera_matrices
    from tpt.config import AtmosphereConfig
    from tpt.sky import compute_atmosphere

    cam = CameraConfig()
    inv_p, inv_v, pos = camera_matrices(cam, width, height)
    env = compute_atmosphere(AtmosphereConfig(size=sky_size))
    return dict(scene=demo_scene().build(), env=env, inv_p=inv_p,
                inv_v=inv_v, pos=pos, focal=jnp.float32(cam.focal_length),
                aperture=jnp.float32(cam.aperture_diameter), cam=cam)


# ---------------------------------------------------------------- phases

def phase_device(card: str):
    import jax
    from tpt.kernels import device
    devs = jax.devices()
    device.set_interpret(False)
    assert not device.interpret_requested()
    assert device.use_interpreter() is False
    say("device", f"platform={devs[0].platform} kind={devs[0].device_kind} "
                  f"count={len(devs)} card={card} interpret=off")


def phase_golden(card: str):
    import jax.numpy as jnp
    from tpt.integrator import apply_environment_blocked
    from tpt.env import pack_block_table
    from tpt.kernels.trace import pallas_trace

    size = 512
    d = demo_setup(size, size, sky_size=32)
    want = np.load(os.path.join(REPO, "tests", "golden",
                                "demo_512.npz"))["image"]

    def run():
        res = pallas_trace(d["scene"], d["inv_p"], d["inv_v"], jnp.int32(0),
                           d["focal"], d["aperture"], width=size,
                           height=size, ray_depth=RAY_DEPTH, spp=SPP,
                           counts=COUNTS)
        return jnp.moveaxis(apply_environment_blocked(
            res, pack_block_table(d["env"]), SPP), 0, -1)

    img, sec = first_call(run)
    frac, mean = image_gate(img, want, "golden")
    say("golden", f"PASS 512^2 kernel vs golden: {frac:.4%} elements off, "
                  f"mean |err| {mean:.2e} (compile+run {sec:.1f} s)")


def phase_forward(card: str):
    import jax
    import jax.numpy as jnp
    from tpt.env import pack_block_table
    from tpt.integrator import (apply_environment, camera_params,
                                compose_trace_fn, make_scene_scan_fn,
                                make_xla_gather_fn, trace_paths)
    from tpt.kernels import render as krender
    from tpt.progressive import init_accumulator
    from tpt import reference

    d = demo_setup(WIDTH, HEIGHT)
    scene, env = d["scene"], d["env"]
    env_table = pack_block_table(env)
    frame_args = (scene, env, d["inv_p"], d["inv_v"], d["pos"], jnp.int32(0),
                  d["focal"], d["aperture"])
    shape = dict(width=WIDTH, height=HEIGHT, ray_depth=RAY_DEPTH, spp=SPP)

    # ---- one frame: compiled kernel vs XLA oracle ----
    (k_img, k_rays), k_sec = first_call(
        lambda: krender.render_fields(*frame_args, counts=COUNTS, **shape))
    (o_img, o_rays), o_sec = first_call(
        lambda: reference.render_fields(*frame_args, **shape))
    frac, mean = image_gate(k_img, o_img, "1080p kernel vs oracle")
    k_rays, o_rays = int(k_rays), int(o_rays)
    ray_dev = abs(k_rays - o_rays) / o_rays
    assert ray_dev < 1e-3, f"ray counts {k_rays} vs {o_rays}"
    say("forward", f"PASS 1080p frame kernel vs oracle: {frac:.4%} elements "
                   f"off, mean |err| {mean:.2e}; rays {k_rays} vs {o_rays} "
                   f"({ray_dev:.2e}); compile+run kernel {k_sec:.1f} s, "
                   f"oracle {o_sec:.1f} s")

    # ---- XLA oracle frame at static counts (the kernel's comparison) ----
    @jax.jit
    def oracle_static(frame):
        py = jax.lax.broadcasted_iota(jnp.int32, (HEIGHT, WIDTH), 0)
        px = jax.lax.broadcasted_iota(jnp.int32, (HEIGHT, WIDTH), 1)
        trace = compose_trace_fn(make_scene_scan_fn(scene, counts=COUNTS),
                                 make_xla_gather_fn(scene))
        cam = camera_params(d["inv_p"], d["inv_v"], d["focal"],
                            d["aperture"])
        res = trace_paths(trace, cam, px, py, WIDTH, HEIGHT, frame,
                          RAY_DEPTH, SPP)
        return apply_environment(res, env, SPP), jnp.sum(res.ray_count)

    _, os_sec = first_call(lambda: oracle_static(jnp.int32(0)))
    for name, fn in (("oracle", lambda: reference.render_fields(
                          *frame_args, **shape)),
                     ("oracle-static", lambda: oracle_static(jnp.int32(0)))):
        sec = timed(fn, 5)
        rays = int(fn()[1])
        say("forward", f"{name} frame: {sec * 1e3:.2f} ms/frame "
                       f"{rays / sec / 1e6:.1f} Mrays/s  [{card}]")
    say("forward", f"compile oracle-static {os_sec:.1f} s")

    # ---- progressive_frames in 30-frame blocks, as bench.py ----
    for refill in (False, True):
        name = "refill" if refill else "per-frame"

        def block(acc, frame0, refill=refill):
            return krender.progressive_frames(
                acc, scene, env_table, d["inv_p"], d["inv_v"],
                jnp.int32(frame0), d["focal"], d["aperture"], counts=COUNTS,
                n_frames=CHUNK, refill=refill, **shape)

        acc = init_accumulator(HEIGHT, WIDTH)
        (acc, _), sec = first_call(lambda: block(acc, 0))
        say("forward", f"compile {name} block: {sec:.1f} s")
        frame = CHUNK
        ts, rays = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            acc, r = block(acc, frame)
            rays.append(int(r))          # fetching syncs the device
            ts.append(time.perf_counter() - t0)
            frame += CHUNK
        assert np.isfinite(np.asarray(acc.image)).all()
        med = float(np.median(ts))
        say("forward", f"{name} kernel: {med / CHUNK * 1e3:.2f} ms/frame "
                       f"{np.mean(rays) / med / 1e6:.1f} Mrays/s  [{card}]")


def _train_inputs(size_w, size_h):
    import jax.numpy as jnp
    from tpt.env import constant_environment
    d = demo_setup(size_w, size_h, sky_size=32)
    d["env"] = constant_environment((0.7, 0.8, 1.0))
    d["target"] = jnp.zeros((size_h, size_w, 3), jnp.float32) + 0.25
    return d


def _train_step(devices, w, h, backend, groups=None, sp=1, optimizer=None):
    """make_train_step on ``devices`` as a (len/sp, sp) mesh."""
    from tpt.config import RenderConfig
    from tpt.parallel import make_mesh, make_train_step
    cfg = RenderConfig(width=w, height=h, ray_depth=RAY_DEPTH, spp=SPP)
    mesh = make_mesh(dp=len(devices) // sp, sp=sp, devices=devices)
    return make_train_step(mesh, cfg, n_sample_groups=groups, counts=COUNTS,
                           backend=backend, russian_roulette=False,
                           optimizer=optimizer)


def _step_grads(step, d, lr=1.0, frame=0):
    """Run one bare-SGD step at lr=1: old - new tables are the gradients."""
    new, loss = step(d["scene"], d["env"], d["inv_p"], d["inv_v"],
                     d["cam"].focal_length, d["cam"].aperture_diameter,
                     frame, d["target"], lr)
    gs = np.asarray(d["scene"].sphere_material) - np.asarray(
        new.sphere_material)
    gc = np.asarray(d["scene"].cuboid_material) - np.asarray(
        new.cuboid_material)
    return np.concatenate([gs[:COUNTS[0]].ravel(), gc[:COUNTS[1]].ravel()]), \
        float(loss)


def grads_close(got, want, rel: float, what: str):
    """Gradient agreement: global-norm relative difference below ``rel``
    and every entry within ``rel`` of the largest entry."""
    diff = np.abs(got - want)
    scale = float(np.abs(want).max())
    norm = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert np.isfinite(got).all(), f"{what}: non-finite gradient"
    assert norm < rel and float(diff.max()) <= rel * scale, (
        f"{what}: relative norm diff {norm:.2e}, max entry diff "
        f"{diff.max():.2e} vs scale {scale:.2e}")
    return norm, float(diff.max()) / scale


def phase_train(card: str):
    import jax
    dev = jax.devices()[:1]

    # ---- 1080p steps: the training default, global-norm-clipped Adam
    # (fixed-depth transport weights rare lobe picks by an unclamped 1/p,
    # so raw gradients carry fireflies; tpt.optim) ----
    from tpt.optim import clipped_adam
    d = _train_inputs(WIDTH, HEIGHT)
    opt = clipped_adam()
    step = _train_step(dev, WIDTH, HEIGHT, "kernel", optimizer=opt)
    opt_state = opt.init((d["scene"].sphere_material,
                          d["scene"].cuboid_material))
    args = (d["scene"], d["env"], d["inv_p"], d["inv_v"],
            d["cam"].focal_length, d["cam"].aperture_diameter, 0,
            d["target"], opt_state)
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    say("train", f"compile 1080p step: {time.perf_counter() - t0:.1f} s")
    mem = compiled.memory_analysis()
    say("train", "memory_analysis: " + ", ".join(
        f"{k}={getattr(mem, k) / 2**30:.2f} GiB" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)))
    scene = d["scene"]
    losses, ts = [], []
    for i in range(4):
        t0 = time.perf_counter()
        scene, opt_state, loss = step(scene, *args[1:6], i, d["target"],
                                      opt_state)
        losses.append(float(loss))       # fetching syncs the device
        ts.append(time.perf_counter() - t0)
    assert np.isfinite(losses).all(), losses
    stats = dev[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0) / 2**30
    say("train", f"PASS 1080p step: loss {losses[-1]:.6f} finite; "
                 f"{np.median(ts[1:]) * 1e3:.1f} ms/step; peak device "
                 f"memory {peak:.2f} GiB  [{card}]")

    # ---- 256^2 gradients: kernel step vs XLA oracle step ----
    g = _train_inputs(GRAD_SIZE, GRAD_SIZE)
    got, l_k = _step_grads(_train_step(dev, GRAD_SIZE, GRAD_SIZE, "kernel"),
                           g)
    with jax.default_matmul_precision("highest"):
        want, l_o = _step_grads(
            _train_step(dev, GRAD_SIZE, GRAD_SIZE, "oracle"), g)
    norm, worst = grads_close(got, want, 1e-2, "256^2 gradients")
    say("train", f"PASS 256^2 material gradients kernel vs oracle: relative "
                 f"norm diff {norm:.2e}, worst entry {worst:.2e} of the "
                 f"largest (tolerance 1e-2); loss {l_k:.6f} vs {l_o:.6f}")


def phase_four(card: str):
    import jax
    from tpt.config import RenderConfig
    from tpt.parallel import make_dist_renderer, make_mesh

    devs = jax.devices()
    assert len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    devs = devs[:4]
    d = demo_setup(WIDTH, HEIGHT)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, ray_depth=RAY_DEPTH,
                       spp=SPP, static_counts=COUNTS)
    rargs = (d["scene"], d["env"], d["inv_p"], d["inv_v"],
             d["cam"].focal_length, d["cam"].aperture_diameter, 0)

    for dp, sp in ((4, 1), (2, 2)):
        one = make_dist_renderer(make_mesh(1, 1, devices=devs[:1]), cfg,
                                 n_sample_groups=sp)
        many = make_dist_renderer(make_mesh(dp, sp, devices=devs), cfg)
        (want, rw), _ = first_call(lambda: one(*rargs))
        (got, rg), _ = first_call(lambda: many(*rargs))
        exact = np.array_equal(np.asarray(got), np.asarray(want))
        assert exact and int(rg) == int(rw), (
            f"dp={dp} sp={sp} render differs from one card "
            f"(max |diff| {np.abs(np.asarray(got) - np.asarray(want)).max()})")
        t1 = timed(lambda: one(*rargs), 3)
        tn = timed(lambda: many(*rargs), 3)
        say("four", f"PASS render dp={dp} sp={sp} bit-exact vs one card; "
                    f"{tn * 1e3:.2f} ms vs {t1 * 1e3:.2f} ms on one card "
                    f"({t1 / tn:.2f}x)  [{card}]")

        t = _train_inputs(WIDTH, HEIGHT)
        step1 = _train_step(devs[:1], WIDTH, HEIGHT, "kernel", groups=sp)
        stepn = _train_step(devs, WIDTH, HEIGHT, "kernel", sp=sp)
        want_g, lw = _step_grads(step1, t)
        got_g, lg = _step_grads(stepn, t)
        # The band split reorders f32 sums of ~2 M per-pixel terms whose
        # magnitudes span ~10 decades (fixed-depth fireflies): rounding
        # differences reach ~5e-4 of the largest entry.  A dropped or
        # doubled band or sample group would be off by 1e-1 or more.
        norm, worst = grads_close(got_g, want_g, 2e-3,
                                  f"dp={dp} sp={sp} gradients")
        targs = (t["scene"], t["env"], t["inv_p"], t["inv_v"],
                 t["cam"].focal_length, t["cam"].aperture_diameter, 1,
                 t["target"], 0.0)
        t1 = timed(lambda: step1(*targs), 2)
        tn = timed(lambda: stepn(*targs), 2)
        say("four", f"PASS train dp={dp} sp={sp} gradients vs one card: "
                    f"relative norm diff {norm:.2e}, worst entry "
                    f"{worst:.2e} (tolerance 2e-3); loss "
                    f"{lg:.6f} vs {lw:.6f}; {tn * 1e3:.1f} ms/step vs "
                    f"{t1 * 1e3:.1f} ms on one card ({t1 / tn:.2f}x)  "
                    f"[{card}]")


def phase_profile(card: str, out_dir: str):
    """One traced oracle frame and one traced training step: device busy
    time, idle share, and the gaps between device operations."""
    import jax
    import jax.numpy as jnp
    from tpt import reference
    from tpt.utils.profiling import device_activity, trace

    d = demo_setup(WIDTH, HEIGHT)
    fargs = (d["scene"], d["env"], d["inv_p"], d["inv_v"], d["pos"],
             jnp.int32(0), d["focal"], d["aperture"])
    shape = dict(width=WIDTH, height=HEIGHT, ray_depth=RAY_DEPTH, spp=SPP)
    jax.block_until_ready(reference.render_fields(*fargs, **shape))
    t = _train_inputs(WIDTH, HEIGHT)
    step = _train_step(jax.devices()[:1], WIDTH, HEIGHT, "kernel")
    sargs = (t["scene"], t["env"], t["inv_p"], t["inv_v"],
             t["cam"].focal_length, t["cam"].aperture_diameter, 0,
             t["target"], 0.01)
    jax.block_until_ready(step(*sargs))
    for name, fn in (("oracle-frame",
                      lambda: reference.render_fields(*fargs, **shape)),
                     ("train-step", lambda: step(*sargs))):
        path = os.path.join(out_dir, name)
        with trace(path):
            jax.block_until_ready(fn())
        act = device_activity(path)
        say("profile", f"{name}: {json.dumps(act)}  [{card}]")


# ------------------------------------------------------------------ main

def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", choices=PHASES, action="append",
                   help="run only these phases (device always runs)")
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded four-card phase")
    p.add_argument("--profile", metavar="DIR",
                   help="also trace an oracle frame and a training step")
    args = p.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tpt.utils import enable_persistent_cache
    from tpt.utils.profiling import card_line
    enable_persistent_cache()

    card = card_line()
    phase_device(card)
    if args.four_cards:
        phase_four(card)
    else:
        for name in args.phase or PHASES:
            if name != "device":
                globals()[f"phase_{name}"](card)
        if args.profile:
            phase_profile(card, args.profile)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
