"""Configuration dataclasses for the path tracer.

Defaults and valid ranges mirror the reference app's hard-coded constants and
ImGui slider ranges:
  - window / image size 832x832, FOV 103 deg, near/far = (0.005, 1000)
    (reference: src/MainWindow.cs:17-24,32)
  - path tracer defaults rayDepth=13, spp=1, focalLength=20, aperture=0.14
    (reference: src/MainWindow.cs:189)
  - GUI ranges: SPP 1-10, rayDepth 1-50, focalLength +-0.1 steps,
    aperture +-0.002 steps (reference: src/Render/Gui.cs:40-66)
  - atmosphere defaults Time=0.5, ISteps=50, JSteps=15, Intensity=15
    (reference: src/Render/AtmosphericScatterer.cs:91-94)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Scene capacity limits (reference: src/MainWindow.cs:17).
MAX_SPHERES = 256
MAX_CUBOIDS = 64

# Geometric epsilon used on the host side (near plane, cuboid thickness)
# (reference: src/MainWindow.cs:18).
HOST_EPSILON = 0.005
# Epsilon used inside the device integrator (ray offset, min lobe probability)
# (reference: res/shaders/PathTracing/compute.glsl:4).
KERNEL_EPSILON = 0.001

FOV_DEGREES = 103.0
NEAR_PLANE = HOST_EPSILON
FAR_PLANE = 1000.0

DEFAULT_WIDTH = 832
DEFAULT_HEIGHT = 832


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) parameters of the renderer.

    These participate in jit as static arguments: they change array shapes or
    trace structure (loop trip counts are kept dynamic where cheap).
    """

    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    ray_depth: int = 13
    spp: int = 1
    # Static (n_spheres, n_cuboids): bakes the primitive-loop trip counts into
    # the compiled program.  None keeps the counts dynamic (one compilation
    # for any scene; needed when objects are added/removed without
    # recompiling).
    static_counts: Tuple[int, int] | None = None
    # Sub-pixel jitter arithmetic: "corner" = the reference's compute-shader
    # convention, "center" = its fragment-shader convention — the shipped
    # app's active default (PathTracer.cs:1 defines _USE_COMPUTE with an
    # underscore, so fragCompute.glsl runs).  Algebraically identical;
    # differs only in float rounding order (tpt.integrator.trace_paths docs).
    jitter: str = "corner"

    def __post_init__(self):
        if self.jitter not in ("corner", "center"):
            raise ValueError(f"jitter must be 'corner' or 'center', got {self.jitter!r}")
        if not (1 <= self.ray_depth <= 50):
            raise ValueError(f"ray_depth must be in [1, 50], got {self.ray_depth}")
        if not (1 <= self.spp):
            raise ValueError(f"spp must be >= 1, got {self.spp}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image size must be positive")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Thin-lens pinhole camera parameters (dynamic; differentiable)."""

    position: Tuple[float, float, float] = (-17.14, 3.53, -8.62)
    look_x: float = -32.2  # yaw, degrees   (reference: src/MainWindow.cs:36)
    look_y: float = 0.8    # pitch, degrees
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_degrees: float = FOV_DEGREES
    focal_length: float = 20.0
    aperture_diameter: float = 0.14


@dataclasses.dataclass(frozen=True)
class AtmosphereConfig:
    """Atmospheric scattering precompute parameters.

    (reference: src/Render/AtmosphericScatterer.cs:12-57,91-94 and
    res/shaders/AtmosphericScattering/compute.glsl:41-53)
    """

    size: int = 256          # cubemap face resolution; GUI offers {32..2048}
    i_steps: int = 50        # primary (in-scatter) march steps
    j_steps: int = 15        # secondary (density) march steps
    time: float = 0.5        # sun position parameter; sun dir = (0, sin, cos)(time*360deg)
    light_intensity: float = 15.0


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Device-mesh configuration for sharded rendering.

    The honest parallel axes of a path tracer are pixels (data parallelism)
    and samples-per-pixel (the "sequence parallel" analogue).  Scene and
    camera parameters are replicated; inverse-rendering parameter gradients
    are psum-reduced over the whole mesh.
    """

    dp: int = 1   # number of mesh slices over pixel rows
    sp: int = 1   # number of mesh slices over the spp axis
    mesh_axis_names: Tuple[str, str] = ("dp", "sp")
