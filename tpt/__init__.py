"""tpt — a differentiable progressive path tracer for the GPU, in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference OpenGL path tracer BoyBaykiller/OpenTK-PathTracer: progressive
Monte-Carlo light transport over an analytic sphere/cuboid scene with a
3-lobe BSDF (diffuse / specular / refractive with Fresnel, Beer's-law
absorption, Russian roulette), thin-lens depth of field, a precomputed
atmospheric-scattering sky or file-loaded cubemap environment, ACES
tonemapping — plus what the reference lacks: differentiability, tests,
multi-chip sharding, checkpointing, and benchmarks.
"""

from .config import (AtmosphereConfig, CameraConfig, DistConfig, RenderConfig,
                     MAX_SPHERES, MAX_CUBOIDS)
from .materials import Material
from .scene import Scene, SceneBuilder, demo_scene, cornell_scene
from .progressive import AccumulatorState, init_accumulator, accumulate, reset

__version__ = "0.1.0"

__all__ = [
    "AtmosphereConfig", "CameraConfig", "DistConfig", "RenderConfig",
    "MAX_SPHERES", "MAX_CUBOIDS", "Material", "Scene", "SceneBuilder",
    "demo_scene", "cornell_scene", "AccumulatorState", "init_accumulator",
    "accumulate", "reset",
]
