"""Direction sampling, matching the shader's draw order exactly.

(reference: res/shaders/PathTracing/compute.glsl:297-314)
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from ..vecmath import Vec3, normalize3

TWO_PI = np.float32(2.0 * math.pi)


def cosine_sample_hemisphere(normal, r_z, r_angle):
    """normalize(normal + uniform_unit_sphere) — cosine-weighted hemisphere
    around ``normal`` (compute.glsl:297-307).

    Draw order: z = r_z*2-1 first, then angle = r_angle*2*pi."""
    z = r_z * 2.0 - 1.0
    a = r_angle * TWO_PI
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    x = r * jnp.cos(a)
    y = r * jnp.sin(a)
    return normalize3(normal + Vec3(x, y, z))


def uniform_sample_unit_circle(r_angle, r_radius):
    """Uniform disk sample (compute.glsl:309-314).

    Draw order: angle first, then radius. Returns (x, y)."""
    angle = r_angle * TWO_PI
    r = jnp.sqrt(r_radius)
    return jnp.cos(angle) * r, jnp.sin(angle) * r
