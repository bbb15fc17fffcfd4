"""Interactive progressive viewer.

Headless-first framework, optional window.  The loop mirrors the reference
app: progressive accumulation that resets on camera motion or any edit,
WASD+QE navigation and mouse-look (Camera.ProcessInputs physics,
src/Camera.cs:35-77), and every ImGui control of src/Render/Gui.cs mapped
to a live action:

  Overview panel      -> screenshot 'p' (Samples_{N}.png, Gui.cs:28-33),
                         spp  '-'/'='   (range 1-10,  Gui.cs:40),
                         depth '['/']'  (range 1-50,  Gui.cs:48),
                         focal 'f'/'g'  (step 0.1,    Gui.cs:55),
                         aperture 'v'/'b' (step 0.002, Gui.cs:62),
                         random materials 'M' (36 grid spheres, Gui.cs:69-73)
  EnvironmentMap panel-> env toggle 'e' (skybox <-> atmosphere, Gui.cs:80-87),
                         atmosphere time 't'/'y' (re-runs the precompute,
                         Gui.cs:114-144),
                         atmosphere resolution ','/'.' (the {32..2048}
                         combo, Gui.cs:93-112)
  GameObjectProperties-> left-click picks (CPU ray cast, Gui.cs:223-262);
                         arrows / 'u'/'o' move the picked object,
                         'm' randomizes its material, '<'/'>' scales
                         specular chance with the reference's cross-clamp
                         (spec + refr <= 1, Gui.cs:193,205)
  window chrome       -> 'V' v-sync analogue (~60 Hz loop cap),
                         F11 fullscreen, 'E' cursor-capture analogue
                         (free-look: bare mouse motion steers)
                         (src/MainWindow.cs:98-123)

All state and edit logic live in :class:`ViewerSession` (pure host code —
unit-tested headless in tests/test_interactive.py); matplotlib is only the
optional display shell.

Run: ``python -m tpt.interactive [--scene demo] [--size 256]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from .config import AtmosphereConfig, CameraConfig, RenderConfig


_display_u8_jit = None


def _display_u8(image):
    """On-device tonemap + 8-bit quantize for the viewer (lazy-jitted)."""
    global _display_u8_jit
    if _display_u8_jit is None:
        import jax
        import jax.numpy as jnp
        from .postfx import post_process

        def f(img):
            return (jnp.clip(post_process(img), 0.0, 1.0) * 255.0
                    + 0.5).astype(jnp.uint8)

        _display_u8_jit = jax.jit(f)
    return _display_u8_jit(image)


class ViewerSession:
    """The reference app's mutable runtime state, functional-core style:
    scene/env/camera/accumulator plus one method per GUI control."""

    def __init__(self, scene_name: str = "demo", size: int = 256,
                 env_name: str = "atmosphere", atmosphere_size: int = 128,
                 screenshot_dir: str = "Screenshots", cubemap_files=None):
        from . import init_accumulator
        from .camera_controller import CameraState
        from .cli import _build_scene

        self.cfg = RenderConfig(width=size, height=size)
        self.scene_name = scene_name
        self.builder = _build_scene(scene_name)
        self.scene = self.builder.build()
        self.base_cam = CameraConfig()
        self.cam = CameraState.from_config(self.base_cam)
        self.atmo = AtmosphereConfig(size=atmosphere_size, i_steps=30,
                                     j_steps=10)
        self.env_is_atmosphere = env_name == "atmosphere"
        # 'e' toggles atmosphere <-> skybox (Gui.cs:80-87).  The reference's
        # skybox is a 6-PNG sRGB cubemap (src/Helper.cs:18-50); pass the
        # face paths to get the same, else a constant-color stand-in.
        self.cubemap_files = list(cubemap_files) if cubemap_files else None
        self._skybox = None  # lazily built constant/file skybox
        self.atmosphere_ms = 0.0  # last precompute GPU+wall ms (Gui.cs:91)
        self.env_faces = self._make_env()
        self.acc = init_accumulator(self.cfg.height, self.cfg.width)
        self.picked = None  # (kind str, index int) into builder lists
        self.screenshot_dir = screenshot_dir
        self.frame_changed = False
        # host mirror of acc.frame: lets the fused render path seed frames
        # and the status line report samples/px without a device fetch
        self._frame_host = 0
        self._env_table = None      # pack_block_table cache, keyed on
        self._env_table_src = None  # the env_faces array identity

    # ---- environment (Gui.cs:80-144) ----
    def _make_env(self):
        if self.env_is_atmosphere:
            from .sky import compute_atmosphere
            t0 = time.time()
            faces = compute_atmosphere(self.atmo)
            faces.block_until_ready()
            # the reference surfaces the precompute time in the GUI via a
            # GL TimerQuery (AtmosphericScatterer.cs:104-112, Gui.cs:91)
            self.atmosphere_ms = (time.time() - t0) * 1e3
            return faces
        if self._skybox is None:
            if self.cubemap_files:
                from .env import load_cubemap_files
                self._skybox = load_cubemap_files(self.cubemap_files)
            else:
                # the bundled 6-PNG sRGB asset, loaded through the same
                # file path the reference uses for res/textures/
                # EnvironmentMap (src/MainWindow.cs:177-187); procedural
                # fallback inside if the asset is missing
                from .env import bundled_skybox
                self._skybox = bundled_skybox()
        return self._skybox

    # the reference's EnvironmentMap resolution combo (Gui.cs:93-112)
    ATMOSPHERE_SIZES = (32, 64, 128, 256, 512, 1024, 2048)

    def set_atmosphere_size(self, size: int):
        """Select an atmosphere cubemap resolution from the reference's combo
        {32..2048} (Gui.cs:93-112): reallocates the cubemap and re-runs the
        precompute."""
        if size not in self.ATMOSPHERE_SIZES:
            raise ValueError(f"atmosphere size {size} not in "
                             f"{self.ATMOSPHERE_SIZES}")
        self.set_atmosphere(size=int(size))

    def adjust_atmosphere_size(self, direction: int):
        """Step through the resolution combo (keyboard analogue)."""
        sizes = self.ATMOSPHERE_SIZES
        i = min(range(len(sizes)), key=lambda k: abs(sizes[k] - self.atmo.size))
        self.set_atmosphere_size(sizes[int(np.clip(i + direction, 0,
                                                   len(sizes) - 1))])

    def toggle_environment(self):
        self.env_is_atmosphere = not self.env_is_atmosphere
        self.env_faces = self._make_env()
        self.invalidate()

    def set_atmosphere(self, **kw):
        """Change atmosphere params (time/i_steps/j_steps/light_intensity/
        size) and re-run the precompute — the GUI re-dispatch path."""
        self.atmo = dataclasses.replace(self.atmo, **kw)
        if self.env_is_atmosphere:
            self.env_faces = self._make_env()
            self.invalidate()

    def adjust_time(self, delta: float):
        self.set_atmosphere(time=float(self.atmo.time + delta))

    # ---- tracer params (Gui.cs:40-66; ranges identical) ----
    def set_spp(self, value: int):
        self.cfg = dataclasses.replace(
            self.cfg, spp=int(np.clip(value, 1, 10)))
        self.invalidate()

    def adjust_spp(self, delta: int):
        self.set_spp(self.cfg.spp + delta)

    def set_ray_depth(self, value: int):
        self.cfg = dataclasses.replace(
            self.cfg, ray_depth=int(np.clip(value, 1, 50)))
        self.invalidate()

    def adjust_ray_depth(self, delta: int):
        self.set_ray_depth(self.cfg.ray_depth + delta)

    def set_focal(self, value: float):
        self.base_cam = dataclasses.replace(
            self.base_cam, focal_length=float(value))
        self.invalidate()

    def adjust_focal(self, delta: float):
        self.set_focal(self.base_cam.focal_length + delta)

    def set_aperture(self, value: float):
        self.base_cam = dataclasses.replace(
            self.base_cam, aperture_diameter=float(value))
        self.invalidate()

    def adjust_aperture(self, delta: float):
        self.set_aperture(self.base_cam.aperture_diameter + delta)

    # ---- camera (src/Camera.cs) ----
    def tick(self, dt: float, keys=(), mouse_delta=(0.0, 0.0)) -> bool:
        from .camera_controller import process_inputs
        self.cam, changed = process_inputs(self.cam, dt, keys, mouse_delta)
        if changed:
            self.invalidate()
        return changed

    # ---- picking + object editing (Gui.cs:156-262) ----
    def pick(self, x: float, y_gl: float):
        from .camera import camera_matrices
        from .pick import pick_pixel
        from .scene import SphereObject
        cam_cfg = self.cam.to_config(self.base_cam)
        inv_p, inv_v, pos = camera_matrices(cam_cfg, self.cfg.width,
                                            self.cfg.height)
        obj, t1, t2 = pick_pixel(self.builder, inv_p, inv_v, pos, x, y_gl,
                                 self.cfg.width, self.cfg.height)
        if obj is None:
            self.picked = None
            return None
        kind = "sphere" if isinstance(obj, SphereObject) else "cuboid"
        group = (self.builder.spheres if kind == "sphere"
                 else self.builder.cuboids)
        self.picked = (kind, group.index(obj))
        return obj

    def _picked_obj(self):
        if self.picked is None:
            return None
        kind, idx = self.picked
        group = (self.builder.spheres if kind == "sphere"
                 else self.builder.cuboids)
        return group[idx]

    def move_picked(self, delta3) -> bool:
        obj = self._picked_obj()
        if obj is None:
            return False
        obj.position = tuple(float(p + d) for p, d in
                             zip(obj.position, delta3))
        self._rebuild()
        return True

    def set_picked_material(self, **params) -> bool:
        """Edit the picked object's material with the reference panel's
        per-edit clamp semantics (Gui.cs:190-206): the EDITED parameter is
        clamped against the untouched one — editing specular_chance on a
        glass object clamps the spec edit to 1-refr and leaves
        refraction_chance alone (the constructor would rewrite refraction
        instead)."""
        from .materials import edit_material
        obj = self._picked_obj()
        if obj is None:
            return False
        obj.material = edit_material(obj.material, **params)
        self._rebuild()
        return True

    def set_picked_position(self, position3) -> bool:
        """The panel's Position DragFloat3 (Gui.cs:164-168): set verbatim."""
        obj = self._picked_obj()
        if obj is None:
            return False
        obj.position = tuple(map(float, position3))
        self._rebuild()
        return True

    @property
    def picked_distance(self) -> float:
        """Camera-to-picked-object distance readout (Gui.cs:161)."""
        obj = self._picked_obj()
        if obj is None:
            return float("nan")
        return float(np.linalg.norm(np.asarray(obj.position)
                                    - np.asarray(self.cam.position)))

    def randomize_picked_material(self) -> bool:
        from .materials import random_material
        obj = self._picked_obj()
        if obj is None:
            return False
        obj.material = random_material(np.random.default_rng())
        self._rebuild()
        return True

    def randomize_grid_materials(self, n: int = 36):
        """The GUI's random-materials button (src/MainWindow.cs:324-336)."""
        from .scene import randomize_materials
        changed = randomize_materials(self.builder, n)
        self._rebuild()
        return changed

    def _rebuild(self):
        self.scene = self.builder.build()
        self.invalidate()

    def reload_scene(self):
        """'R': rebuild the scene from scratch — the reference re-runs
        LoadScene and resets (src/MainWindow.cs:109-123).  Discards every
        object edit and the pick."""
        from .cli import _build_scene
        self.builder = _build_scene(self.scene_name)
        self.picked = None
        self._rebuild()

    def set_size(self, width: int, height: int):
        """Window-resize semantics: reallocate the accumulator and reset
        (PathTracer.SetSize, src/Render/PathTracer.cs:131-137); the inverse
        projection is recomputed per frame from the new size
        (src/MainWindow.cs:270-283)."""
        from . import init_accumulator
        self.cfg = dataclasses.replace(self.cfg, width=int(width),
                                       height=int(height))
        self.acc = init_accumulator(self.cfg.height, self.cfg.width)
        self._frame_host = 0

    # ---- accumulation ----
    def invalidate(self):
        from . import reset
        self.acc = reset(self.acc)
        self._frame_host = 0

    @property
    def env_table(self):
        """Blocked env-gather table for the fused render path, rebuilt only
        when the environment changes (the reference's analogue is
        re-uploading the cubemap texture)."""
        if self._env_table_src is not self.env_faces:
            from .env import pack_block_table
            self._env_table = pack_block_table(self.env_faces)
            self._env_table_src = self.env_faces
        return self._env_table

    def _static_counts(self):
        """Specialize the compiled kernel's primitive loops to the scene
        counts (the viewer never adds/removes objects, so the counts are
        stable).  The interpreted kernel keeps them dynamic: one program
        serves every count, matching tpt.cli."""
        from .kernels.device import use_interpreter
        if self.cfg.static_counts is not None:
            return self.cfg.static_counts
        if use_interpreter():
            return None
        return (int(self.scene.num_spheres), int(self.scene.num_cuboids))

    def render_one(self, n_frames: int = 1):
        """Fold ``n_frames`` progressive frames into the accumulator in ONE
        device program (the production fused path: Pallas trace -> blocked
        env gather -> donated accumulate, kernels.render.progressive_frames)
        and return the display image as a uint8 numpy array.  One launch +
        one host sync per draw — the same per-frame cost profile as the
        reference's render loop (src/MainWindow.cs:40-69).  The tonemap +
        8-bit quantization happen ON DEVICE (the reference's display
        surface is 8-bit RGBA8 too, ScreenEffect.cs:24) so the per-draw
        host fetch moves a quarter of the bytes."""
        import jax.numpy as jnp
        from .camera import camera_matrices
        from .kernels.render import progressive_frames
        cam_cfg = self.cam.to_config(self.base_cam)
        inv_p, inv_v, _pos = camera_matrices(cam_cfg, self.cfg.width,
                                             self.cfg.height)
        self.acc, _rays = progressive_frames(
            self.acc, self.scene, self.env_table, inv_p, inv_v,
            jnp.int32(self._frame_host), jnp.float32(cam_cfg.focal_length),
            jnp.float32(cam_cfg.aperture_diameter),
            width=self.cfg.width, height=self.cfg.height,
            ray_depth=self.cfg.ray_depth, spp=self.cfg.spp,
            counts=self._static_counts(), n_frames=n_frames,
            jitter=self.cfg.jitter)
        self._frame_host += n_frames
        return np.asarray(_display_u8(self.acc.image))

    def screenshot(self) -> str:
        from .postfx import post_process
        from .utils import write_png
        n = self.samples_per_pixel
        os.makedirs(self.screenshot_dir, exist_ok=True)
        path = os.path.join(self.screenshot_dir, f"Samples_{n}.png")
        write_png(path, np.asarray(post_process(self.acc.image)))
        return path

    @property
    def samples_per_pixel(self) -> int:
        # host mirror of acc.frame — no device fetch in the status line
        return self._frame_host * self.cfg.spp

    @property
    def f_number(self) -> float:
        """Lens f-number = focal length / aperture diameter (Gui.cs:67)."""
        ap = self.base_cam.aperture_diameter
        return self.base_cam.focal_length / ap if ap > 0 else float("inf")


class ControlPanel:
    """Widget-panel analogue of the reference's ImGui windows
    (src/Render/Gui.cs) built on matplotlib.widgets: one slider/button per
    GUI control, with the reference's ranges, all driving a ViewerSession.

    Works headless under the Agg backend (Slider.set_val triggers the same
    callbacks a drag does — tests/test_interactive.py drives it that way).
    """

    def __init__(self, ses: "ViewerSession", fig=None):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, Slider

        self.ses = ses
        self.fig = fig or plt.figure(figsize=(4.2, 6.2))
        self.fig.canvas.manager.set_window_title("tpt controls") \
            if hasattr(self.fig.canvas.manager, "set_window_title") else None

        def row(i, h=0.035):
            return self.fig.add_axes([0.32, 0.95 - i * 0.055, 0.58, h])

        # Overview panel (Gui.cs:40-66)
        self.s_spp = Slider(row(0), "SPP", 1, 10, valinit=ses.cfg.spp,
                            valstep=1)
        self.s_spp.on_changed(lambda v: ses.set_spp(int(v)))
        self.s_depth = Slider(row(1), "MaxRayDepth", 1, 50,
                              valinit=ses.cfg.ray_depth, valstep=1)
        self.s_depth.on_changed(lambda v: ses.set_ray_depth(int(v)))
        self.s_focal = Slider(row(2), "FocalLength", 0.1, 60.0,
                              valinit=ses.base_cam.focal_length)
        self.s_focal.on_changed(ses.set_focal)
        self.s_aperture = Slider(row(3), "ApertureDiam", 0.0, 0.6,
                                 valinit=ses.base_cam.aperture_diameter)
        self.s_aperture.on_changed(ses.set_aperture)

        # EnvironmentMap panel (Gui.cs:93-144)
        self.s_time = Slider(row(4), "Time", 0.0, 1.0,
                             valinit=ses.atmo.time)
        self.s_time.on_changed(lambda v: ses.set_atmosphere(time=float(v)))
        self.s_intensity = Slider(row(5), "Intensity", 0.0, 40.0,
                                  valinit=ses.atmo.light_intensity)
        self.s_intensity.on_changed(
            lambda v: ses.set_atmosphere(light_intensity=float(v)))
        self.s_isteps = Slider(row(6), "ISteps", 1, 100,
                               valinit=ses.atmo.i_steps, valstep=1)
        self.s_isteps.on_changed(
            lambda v: ses.set_atmosphere(i_steps=int(v)))
        self.s_jsteps = Slider(row(7), "JSteps", 1, 40,
                               valinit=ses.atmo.j_steps, valstep=1)
        self.s_jsteps.on_changed(
            lambda v: ses.set_atmosphere(j_steps=int(v)))
        # resolution combo {32..2048} (Gui.cs:93-112) as an index slider
        sizes = ses.ATMOSPHERE_SIZES
        init_i = min(range(len(sizes)),
                     key=lambda k: abs(sizes[k] - ses.atmo.size))
        self.s_size = Slider(row(8), f"Resolution {sizes}", 0, len(sizes) - 1,
                             valinit=init_i, valstep=1)
        self.s_size.on_changed(
            lambda v: ses.set_atmosphere_size(sizes[int(v)]))

        def button(i, label, cb):
            b = Button(self.fig.add_axes([0.1, 0.95 - i * 0.055, 0.8, 0.04]),
                       label)
            b.on_clicked(lambda _ev: cb())
            return b

        self.b_env = button(9, "Toggle atmosphere/skybox", ses.toggle_environment)
        self.b_shot = button(10, "Screenshot", ses.screenshot)
        self.b_rand = button(11, "Random materials (36)",
                             ses.randomize_grid_materials)
        self.b_reload = button(12, "Reload scene", ses.reload_scene)


class ObjectPanel:
    """GameObjectProperties window analogue (src/Render/Gui.cs:153-218):
    camera-distance readout, Position DragFloat3, Albedo/Emissiv/
    AbsorbanceColor InputFloat3s, and the five material sliders with the
    reference's ranges and per-edit cross-clamping — all driving a
    ViewerSession's picked object.

    The reference shows the window only while an object is picked; here the
    panel always exists and :meth:`refresh` re-reads the current pick (the
    viewer calls it after every click).  Headless-testable under Agg the
    same way ControlPanel is (Slider.set_val / TextBox.set_val fire the
    drag/submit callbacks).
    """

    def __init__(self, ses: "ViewerSession", fig=None):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider, TextBox

        self.ses = ses
        self._updating = False  # guard: refresh() must not re-enter edits
        self.fig = fig or plt.figure(figsize=(4.2, 4.6))
        if hasattr(self.fig.canvas.manager, "set_window_title"):
            self.fig.canvas.manager.set_window_title("tpt object")

        def row(i, h=0.05):
            return self.fig.add_axes([0.34, 0.92 - i * 0.085, 0.56, h])

        # distance readout (Gui.cs:161)
        self.t_distance = self.fig.text(0.06, 0.965, "picked: nothing")

        def vec3_box(i, label, cb):
            box = TextBox(row(i), label, initial="0, 0, 0")
            box.on_submit(lambda text: self._edit_vec3(text, cb))
            return box

        # Position DragFloat3 + the three InputFloat3s (Gui.cs:164-188)
        self.t_position = vec3_box(1, "Position", ses.set_picked_position)
        self.t_albedo = vec3_box(
            2, "Albedo", lambda v: ses.set_picked_material(albedo=v))
        self.t_emissive = vec3_box(
            3, "Emissiv", lambda v: ses.set_picked_material(emissive=v))
        self.t_absorbance = vec3_box(
            4, "AbsorbanceColor",
            lambda v: ses.set_picked_material(absorbance=v))

        def slider(i, label, lo, hi, key):
            s = Slider(row(i, h=0.04), label, lo, hi, valinit=lo)
            s.on_changed(lambda v: self._edit_scalar(key, v, s))
            return s

        # the five sliders, reference ranges (Gui.cs:191-209)
        self.s_spec = slider(5, "SpecularChance", 0.0, 1.0,
                             "specular_chance")
        self.s_spec_rough = slider(6, "SpecularRoughness", 0.0, 1.0,
                                   "specular_roughness")
        self.s_ior = slider(7, "IndexOfRefraction", 1.0, 5.0, "ior")
        self.s_refr = slider(8, "RefractionChance", 0.0, 1.0,
                             "refraction_chance")
        self.s_refr_rough = slider(9, "RefractionRoughnes", 0.0, 1.0,
                                   "refraction_roughness")

    def _edit_vec3(self, text, cb):
        if self._updating or self.ses.picked is None:
            return
        try:
            v = tuple(float(p) for p in text.replace(",", " ").split())
        except ValueError:
            return
        if len(v) == 3:
            cb(v)
            self.refresh()

    def _edit_scalar(self, key, value, slider):
        if self._updating or self.ses.picked is None:
            return
        self.ses.set_picked_material(**{key: float(value)})
        # show the post-clamp value (the reference writes the clamped value
        # back into the ImGui field the same way, Gui.cs:193,205)
        actual = getattr(self.ses._picked_obj().material, key)
        if abs(actual - float(value)) > 1e-9:
            self._set_val(slider, actual)

    def _set_val(self, widget, value):
        self._updating = True
        try:
            widget.set_val(value)
        finally:
            self._updating = False

    def refresh(self):
        """Re-read the picked object into the widgets (call after a pick)."""
        obj = self.ses._picked_obj()
        if obj is None:
            self.t_distance.set_text("picked: nothing")
            return
        m = obj.material
        self.t_distance.set_text(
            f"picked: {type(obj).__name__}   "
            f"Distance {self.ses.picked_distance:.3f}")

        def fmt(v3):
            return ", ".join(f"{c:.4g}" for c in v3)

        self._set_val(self.t_position, fmt(obj.position))
        self._set_val(self.t_albedo, fmt(m.albedo))
        self._set_val(self.t_emissive, fmt(m.emissive))
        self._set_val(self.t_absorbance, fmt(m.absorbance))
        self._set_val(self.s_spec, m.specular_chance)
        self._set_val(self.s_spec_rough, m.specular_roughness)
        self._set_val(self.s_ior, m.ior)
        self._set_val(self.s_refr, m.refraction_chance)
        self._set_val(self.s_refr_rough, m.refraction_roughness)


class FrameStats:
    """FPS/UPS counters refreshed once per second, like the reference's
    window title (src/MainWindow.cs:71-82), plus the derived
    Samples/Pixel/Second = FPS * SPP stat (src/Render/Gui.cs:36-37).
    ``note_frames`` counts *rendered* frames (a fused draw folds several),
    ``note_update`` counts input ticks."""

    def __init__(self, now: float = 0.0):
        self.fps = 0.0    # rendered frames/s over the last whole second
        self.ups = 0.0    # update ticks/s
        self.sps = 0.0    # samples/pixel/second = frames/s * spp
        self._frames = 0
        self._updates = 0
        self._spp = 1
        self._t0 = now

    def note_frames(self, n: int, spp: int = 1):
        self._frames += n
        self._spp = spp

    def note_update(self):
        self._updates += 1

    def sample(self, now: float) -> bool:
        """Roll the 1 s window; returns True when the stats were refreshed."""
        dt = now - self._t0
        if dt < 1.0:
            return False
        self.fps = self._frames / dt
        self.ups = self._updates / dt
        self.sps = self.fps * self._spp
        self._frames = 0
        self._updates = 0
        self._t0 = now
        return True


def run_viewer(scene_name: str = "demo", size: int = 256,
               env_name: str = "atmosphere", frames_per_draw: int = 1,
               cubemap_files=None, panel: bool = False) -> int:
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        print("interactive viewer requires matplotlib", file=sys.stderr)
        return 1

    ses = ViewerSession(scene_name, size, env_name,
                        cubemap_files=cubemap_files)
    # keep a strong reference: matplotlib widgets die when collected
    control_panel = ControlPanel(ses) if panel else None  # noqa: F841
    object_panel = ObjectPanel(ses) if panel else None
    keys_down = set()
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(np.zeros((ses.cfg.height, ses.cfg.width, 3)),
                   origin="lower", interpolation="nearest")
    ax.set_axis_off()
    status = ax.set_title("tpt — WASD move, drag look, click pick, p png, "
                          "-/= spp, [/] depth, f/g focal, v/b apert, "
                          "e env, t/y time, m/M rnd mat")

    key_map = {"w": "w", "a": "a", "s": "s", "d": "d",
               "shift": "shift", "control": "ctrl"}
    drag = {"pos": None, "moved": False, "delta": (0.0, 0.0)}
    # window-chrome toggles (src/MainWindow.cs:98-123): 'V' = v-sync
    # analogue (cap the loop at ~60 Hz), F11 = fullscreen, 'E' = cursor
    # capture analogue (free-look: mouse motion steers without dragging)
    chrome = {"vsync": False, "freelook": False, "last_xy": None}

    def toggle_fullscreen():
        mgr = fig.canvas.manager
        if hasattr(mgr, "full_screen_toggle"):
            mgr.full_screen_toggle()

    def toggle_freelook():
        chrome["freelook"] = not chrome["freelook"]
        chrome["last_xy"] = None
        print("free-look", "on" if chrome["freelook"] else "off")

    def toggle_vsync():
        chrome["vsync"] = not chrome["vsync"]
        print("vsync cap", "on" if chrome["vsync"] else "off")

    actions = {
        "V": toggle_vsync,
        "f11": toggle_fullscreen,
        "E": toggle_freelook,
        "p": lambda: print("wrote", ses.screenshot()),
        "r": ses.invalidate,
        "R": ses.reload_scene,
        "-": lambda: ses.adjust_spp(-1), "=": lambda: ses.adjust_spp(1),
        "[": lambda: ses.adjust_ray_depth(-1),
        "]": lambda: ses.adjust_ray_depth(1),
        "f": lambda: ses.adjust_focal(-0.1),
        "g": lambda: ses.adjust_focal(0.1),
        "v": lambda: ses.adjust_aperture(-0.002),
        "b": lambda: ses.adjust_aperture(0.002),
        "e": ses.toggle_environment,
        "t": lambda: ses.adjust_time(-0.02), "y": lambda: ses.adjust_time(0.02),
        # atmosphere resolution combo {32..2048} (Gui.cs:93-112)
        ",": lambda: ses.adjust_atmosphere_size(-1),
        ".": lambda: ses.adjust_atmosphere_size(1),
        "m": ses.randomize_picked_material,
        "M": ses.randomize_grid_materials,
        "left": lambda: ses.move_picked((-0.5, 0, 0)),
        "right": lambda: ses.move_picked((0.5, 0, 0)),
        "up": lambda: ses.move_picked((0, 0, -0.5)),
        "down": lambda: ses.move_picked((0, 0, 0.5)),
        "u": lambda: ses.move_picked((0, 0.5, 0)),
        "o": lambda: ses.move_picked((0, -0.5, 0)),
        "<": lambda: ses.set_picked_material(
            specular_chance=(ses._picked_obj().material.specular_chance - 0.05
                             if ses._picked_obj() else 0)),
        ">": lambda: ses.set_picked_material(
            specular_chance=(ses._picked_obj().material.specular_chance + 0.05
                             if ses._picked_obj() else 0)),
    }

    def on_key(event, down):
        k = key_map.get(event.key)
        if k:
            (keys_down.add if down else keys_down.discard)(k)
        elif down and event.key in actions:
            actions[event.key]()

    def on_press(event):
        if event.inaxes is ax and event.xdata is not None:
            drag["pos"] = (event.x, event.y)
            drag["moved"] = False

    def on_motion(event):
        if event.x is None:
            return
        if chrome["freelook"] and drag["pos"] is None:
            # cursor-captured look: steer from bare mouse motion ('E',
            # the reference's CursorVisible toggle)
            if chrome["last_xy"] is not None:
                dx = event.x - chrome["last_xy"][0]
                dy = event.y - chrome["last_xy"][1]
                drag["delta"] = (drag["delta"][0] + dx,
                                 drag["delta"][1] - dy)
            chrome["last_xy"] = (event.x, event.y)
            return
        if drag["pos"] is None:
            return
        dx = event.x - drag["pos"][0]
        dy = event.y - drag["pos"][1]
        if dx or dy:
            drag["moved"] = True
            # GL window coords are y-down; matplotlib's are y-up
            drag["delta"] = (drag["delta"][0] + dx, drag["delta"][1] - dy)
            drag["pos"] = (event.x, event.y)

    def on_release(event):
        if drag["pos"] is not None and not drag["moved"] \
                and event.inaxes is ax and event.xdata is not None:
            obj = ses.pick(event.xdata, ses.cfg.height - event.ydata)
            if obj is None:
                print("picked: nothing")
            else:
                print(f"picked: {type(obj).__name__} at {obj.position}: "
                      f"{obj.material}")
            if object_panel is not None:
                object_panel.refresh()
        drag["pos"] = None

    fig.canvas.mpl_connect("key_press_event", lambda e: on_key(e, True))
    fig.canvas.mpl_connect("key_release_event", lambda e: on_key(e, False))
    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("motion_notify_event", on_motion)
    fig.canvas.mpl_connect("button_release_event", on_release)

    last = time.time()
    stats = FrameStats(last)
    stats_txt = ""
    while plt.fignum_exists(fig.number):
        now = time.time()
        dt = min(now - last, 0.1)
        last = now
        delta = drag["delta"]
        drag["delta"] = (0.0, 0.0)
        ses.tick(dt, keys_down, delta)
        stats.note_update()
        # the fused production path: frames_per_draw frames in ONE device
        # program + one host sync, instead of a Python loop of launches
        disp = ses.render_one(n_frames=frames_per_draw)
        stats.note_frames(frames_per_draw, ses.cfg.spp)
        im.set_data(disp)
        if stats.sample(time.time()):
            # FPS/UPS + samples-per-pixel-per-second, 1 s refresh
            # (MainWindow.cs:71-82, Gui.cs:36-37)
            stats_txt = (f"FPS {stats.fps:.0f}  UPS {stats.ups:.0f}  "
                         f"SPS {stats.sps:.0f}   ")
        status.set_text(f"{stats_txt}samples/px: {ses.samples_per_pixel}   "
                        f"pos: {np.round(ses.cam.position, 2)}   "
                        f"f/{ses.f_number:.1f}   "
                        f"atmo {ses.atmosphere_ms:.0f} ms")
        fig.canvas.draw_idle()
        # v-sync analogue: cap the loop near 60 Hz when toggled on ('V')
        plt.pause(max(0.001, 1.0 / 60.0 - (time.time() - now))
                  if chrome["vsync"] else 0.001)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="demo")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--env", default="atmosphere")
    p.add_argument("--cubemap-files", default="",
                   help="6 comma-separated face images (+X,-X,+Y,-Y,+Z,-Z) "
                        "for the 'e' skybox toggle")
    p.add_argument("--panel", action="store_true",
                   help="open a widget control panel (ImGui-panel analogue)")
    p.add_argument("--frames-per-draw", type=int, default=1,
                   help="progressive frames folded into ONE device program "
                        "per display update (the fused refill path; higher "
                        "values amortize the per-draw host sync)")
    args = p.parse_args(argv)
    files = args.cubemap_files.split(",") if args.cubemap_files else None
    return run_viewer(args.scene, args.size, args.env,
                      frames_per_draw=args.frames_per_draw,
                      cubemap_files=files, panel=args.panel)


if __name__ == "__main__":
    sys.exit(main())
