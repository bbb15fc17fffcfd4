"""Command-line render driver.

The headless equivalent of the reference's window + ImGui app: every runtime
control the GUI exposes (src/Render/Gui.cs) is a flag with the same range and
default, renders accumulate progressively, and screenshots use the
``Samples_{N}.png`` naming scheme (Gui.cs:32).

Usage:
    python -m tpt.cli render --frames 64 --out out.png
    python -m tpt.cli render --scene demo --env atmosphere --time 0.2 \
        --width 1024 --height 1024 --spp 2 --checkpoint state.npz
    python -m tpt.cli sky --size 256 --out sky.png       # debug face strip
    python -m tpt.cli pick --x 416 --y 416               # CPU picking
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _build_scene(name: str):
    from . import scene as scene_mod
    builders = {"demo": scene_mod.demo_scene, "cornell": scene_mod.cornell_scene}
    if name not in builders:
        raise SystemExit(f"unknown scene '{name}' (choose from {sorted(builders)})")
    return builders[name]()


def _build_env(args):
    import jax.numpy as jnp
    from .config import AtmosphereConfig
    if args.env == "constant":
        from .env import constant_environment
        color = tuple(float(c) for c in args.env_color.split(","))
        return constant_environment(color)
    if args.env == "atmosphere":
        from .sky import compute_atmosphere
        cfg = AtmosphereConfig(size=args.atmosphere_size, i_steps=args.isteps,
                               j_steps=args.jsteps, time=args.time,
                               light_intensity=args.light_intensity)
        return compute_atmosphere(cfg)
    if args.env == "cubemap":
        from .env import load_cubemap_files
        paths = args.cubemap_files.split(",")
        return load_cubemap_files(paths)
    if args.env == "skybox":
        # the bundled 6-PNG sRGB asset, like the reference's
        # res/textures/EnvironmentMap (src/MainWindow.cs:177-187);
        # falls back to the procedural tpt.env.default_skybox
        from .env import bundled_skybox
        return bundled_skybox()
    raise SystemExit(f"unknown env '{args.env}'")


def _camera_from_args(args):
    from .config import CameraConfig
    pos = tuple(float(c) for c in args.camera_pos.split(","))
    return CameraConfig(position=pos, look_x=args.yaw, look_y=args.pitch,
                        fov_degrees=args.fov, focal_length=args.focal_length,
                        aperture_diameter=args.aperture)


def _add_common_flags(p):
    # defaults/ranges mirror src/MainWindow.cs:189 and src/Render/Gui.cs:40-66
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--height", type=int, default=832)
    p.add_argument("--spp", type=int, default=1, help="samples/pixel/frame (GUI range 1-10)")
    p.add_argument("--ray-depth", type=int, default=13, help="max bounces (GUI range 1-50)")
    p.add_argument("--jitter", default="corner", choices=["corner", "center"],
                   help="sub-pixel jitter arithmetic: compute-shader corner "
                        "convention or the shipped fragment variant's "
                        "centered convention (algebraically identical)")
    p.add_argument("--focal-length", type=float, default=20.0)
    p.add_argument("--aperture", type=float, default=0.14)
    p.add_argument("--fov", type=float, default=103.0)
    p.add_argument("--camera-pos", default="-17.14,3.53,-8.62")
    p.add_argument("--yaw", type=float, default=-32.2)
    p.add_argument("--pitch", type=float, default=0.8)
    p.add_argument("--scene", default="demo")
    p.add_argument("--env", default="atmosphere",
                   choices=["atmosphere", "constant", "cubemap", "skybox"])
    p.add_argument("--env-color", default="0.7,0.8,1.0")
    p.add_argument("--env-seamless", action="store_true",
                   help="GL-seamless cubemap filtering analogue (the "
                        "reference enables seamless mode, MainWindow.cs"
                        ":168): pad the env table with adjacent-face edge "
                        "texels so cross-face taps blend both faces — "
                        "zero runtime cost, changes border-texel values "
                        "vs the default clamp policy")
    p.add_argument("--env-bf16", action="store_true",
                   help="half-width environment gather table (bf16 texels "
                        "bit-packed in f32 words): texels round to an 8-bit "
                        "mantissa, below GL bilinear filter precision but "
                        "outside the f32 oracle-parity contract")
    p.add_argument("--cubemap-files", default="",
                   help="6 comma-separated face images (+X,-X,+Y,-Y,+Z,-Z)")
    p.add_argument("--atmosphere-size", type=int, default=256)
    p.add_argument("--isteps", type=int, default=50)
    p.add_argument("--jsteps", type=int, default=15)
    p.add_argument("--time", type=float, default=0.5)
    p.add_argument("--light-intensity", type=float, default=15.0)
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu) before first use")


def _maybe_force_platform(args):
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    from .utils import enable_persistent_cache
    enable_persistent_cache()


def cmd_render(args) -> int:
    _maybe_force_platform(args)
    import jax.numpy as jnp
    from .config import RenderConfig
    from .postfx import post_process
    from .progressive import (init_accumulator, load_checkpoint, save_checkpoint,
                              samples_per_pixel)
    from .utils import write_png

    cfg = RenderConfig(width=args.width, height=args.height,
                       ray_depth=args.ray_depth, spp=args.spp,
                       jitter=args.jitter)
    builder = _build_scene(args.scene)
    scene = builder.build()
    env_faces = _build_env(args)
    camera = _camera_from_args(args)

    if args.resume and os.path.exists(args.resume):
        state = load_checkpoint(args.resume)
        print(f"resumed from {args.resume} at frame {int(state.frame)}")
    else:
        state = init_accumulator(cfg.height, cfg.width)

    t0 = time.time()
    total_rays = 0
    if args.backend == "kernel":
        # Production path: fused chunks of (trace kernel -> one-row-gather
        # env fetch -> donated accumulate) in one device program, with the
        # scan loops specialized to the scene's primitive counts.
        import jax.numpy as jnp
        from .camera import camera_matrices
        from .env import pack_block_table
        from .kernels.device import use_interpreter
        from .kernels.render import progressive_frames
        # the compiled kernel specializes its primitive loops to the
        # scene's counts; the interpreted one keeps them dynamic (one
        # program for any scene).  Off the GPU with no interpreter request
        # this raises and names --backend oracle.
        counts = (None if use_interpreter() else
                  (int(scene.num_spheres), int(scene.num_cuboids)))
        env_table = pack_block_table(
            env_faces, dtype=jnp.bfloat16 if args.env_bf16 else jnp.float32,
            seamless=args.env_seamless)
        inv_p, inv_v, _ = camera_matrices(camera, cfg.width, cfg.height)
        focal = jnp.float32(camera.focal_length)
        aperture = jnp.float32(camera.aperture_diameter)

        chunk = min(args.chunk, args.frames)

        def run_chunk(state, n):
            # always launch the same n_frames=chunk program; a partial tail
            # masks the extra steps via n_valid instead of paying a second
            # compile for the remainder size
            state, rays = progressive_frames(
                state, scene, env_table, inv_p, inv_v,
                jnp.int32(int(state.frame)), focal, aperture,
                width=cfg.width, height=cfg.height, ray_depth=cfg.ray_depth,
                spp=cfg.spp, counts=counts, n_frames=chunk,
                n_valid=jnp.int32(n), jitter=cfg.jitter)
            return state, int(rays)

        done = 0
        last_ckpt = 0
        while done < args.frames:
            n = min(chunk, args.frames - done)
            state, rays = run_chunk(state, n)
            done += n
            total_rays += rays
            dt = time.time() - t0
            mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
            print(f"frame {int(state.frame)}/{args.frames}  "
                  f"samples/px {int(samples_per_pixel(state, cfg.spp))}  "
                  f"{mrays:.1f} Mrays/s", flush=True)
            # checkpoint whenever the quotient advances (chunked progress
            # rarely lands exactly on a multiple of --checkpoint-every)
            if args.checkpoint and (done // args.checkpoint_every
                                    > last_ckpt // args.checkpoint_every
                                    or done == args.frames):
                save_checkpoint(args.checkpoint, state)
                last_ckpt = done
    else:
        from .progressive import accumulate
        from .reference import render_frame as frame_fn
        report_every = max(1, args.frames // 10)
        for i in range(args.frames):
            image, rays = frame_fn(scene, env_faces, camera, cfg,
                                   int(state.frame))
            state = accumulate(state, image)
            total_rays += int(rays)
            if (i + 1) % report_every == 0 or i + 1 == args.frames:
                dt = time.time() - t0
                mrays = total_rays / dt / 1e6 if dt > 0 else 0.0
                print(f"frame {int(state.frame)}/{args.frames}  "
                      f"samples/px {int(samples_per_pixel(state, cfg.spp))}  "
                      f"{mrays:.1f} Mrays/s", flush=True)
            if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
                save_checkpoint(args.checkpoint, state)

    if args.checkpoint:
        save_checkpoint(args.checkpoint, state)

    out = args.out
    if not out:
        os.makedirs(args.out_dir, exist_ok=True)
        n = int(samples_per_pixel(state, cfg.spp))
        out = os.path.join(args.out_dir, f"Samples_{n}.png")
    write_png(out, np.asarray(post_process(state.image)))
    dt = time.time() - t0
    print(f"wrote {out}  ({total_rays/1e6:.1f} Mrays in {dt:.1f}s, "
          f"{total_rays/dt/1e6:.1f} Mrays/s)")
    return 0


def cmd_sky(args) -> int:
    _maybe_force_platform(args)
    from .config import AtmosphereConfig
    from .postfx import post_process
    from .sky import compute_atmosphere
    from .utils import write_png

    cfg = AtmosphereConfig(size=args.atmosphere_size, i_steps=args.isteps,
                           j_steps=args.jsteps, time=args.time,
                           light_intensity=args.light_intensity)
    t0 = time.time()
    faces = compute_atmosphere(cfg)
    faces.block_until_ready()
    dt = (time.time() - t0) * 1e3
    print(f"atmosphere {cfg.size}^2 x6 in {dt:.1f} ms "
          f"(iSteps={cfg.i_steps} jSteps={cfg.j_steps})")
    strip = np.concatenate(list(np.asarray(post_process(faces))), axis=1)
    write_png(args.out, strip)
    print(f"wrote {args.out} (face strip +X,-X,+Y,-Y,+Z,-Z)")
    return 0


def cmd_pick(args) -> int:
    from .camera import camera_matrices
    from .pick import pick_pixel
    from .scene import SphereObject

    builder = _build_scene(args.scene)
    camera = _camera_from_args(args)
    inv_p, inv_v, pos = camera_matrices(camera, args.width, args.height)
    obj, t1, t2 = pick_pixel(builder, inv_p, inv_v, pos, args.x, args.y,
                             args.width, args.height)
    if obj is None:
        print("picked: nothing")
    else:
        kind = "sphere" if isinstance(obj, SphereObject) else "cuboid"
        idx = builder.objects.index(obj)
        print(f"picked: {kind} object #{idx} at {obj.position} (t1={t1:.3f}, t2={t2:.3f})")
        print(f"  material: {obj.material}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpt", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="progressive render to PNG")
    _add_common_flags(p)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--out-dir", default="Screenshots")
    p.add_argument("--backend", default="kernel", choices=["kernel", "oracle"])
    p.add_argument("--chunk", type=int, default=8,
                   help="frames fused per device program (kernel backend)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--resume", default=None)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("sky", help="precompute the atmosphere cubemap to PNG")
    _add_common_flags(p)
    p.add_argument("--out", default="sky.png")
    p.set_defaults(fn=cmd_sky)

    p = sub.add_parser("pick", help="CPU ray picking at a window coordinate")
    _add_common_flags(p)
    p.add_argument("--x", type=float, required=True)
    p.add_argument("--y", type=float, required=True)
    p.set_defaults(fn=cmd_pick)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
