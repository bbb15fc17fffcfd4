"""Analytic ray/primitive intersection and normals.

Mirrors the device intersectors of the reference
(res/shaders/PathTracing/compute.glsl:261-294,316-332) and their CPU
duplicates (src/GameObjects/Sphere.cs:34-50, src/GameObjects/Cuboid.cs:38-52).
All functions are elementwise over arbitrary batch shapes; vectors are
:class:`tpt.vecmath.Vec3` values.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import KERNEL_EPSILON
from ..vecmath import dot3, normalize3, sqrt_clamped_grad, v3map

FLOAT_MAX = np.float32(3.4028235e38)
FLOAT_MIN = np.float32(-3.4028235e38)


def ray_sphere(origin, direction, center, radius):
    """Quadratic sphere test; assumes ``direction`` normalized
    (compute.glsl:261-277).  Returns (t1, t2, ok)."""
    oc = origin - center
    b = dot3(direction, oc)
    c = dot3(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    # guard value 1.0 (not max(disc,0)): sqrt at exactly 0 has an infinite
    # derivative and the masked-out lanes would emit NaN *tangents*
    sq = sqrt_clamped_grad(jnp.where(ok, jnp.maximum(disc, 0.0), 1.0))
    t1 = -b - sq
    t2 = -b + sq
    # GLSL additionally returns t1 <= t2, which holds whenever disc >= 0.
    return t1, t2, ok


def ray_cuboid(origin, direction, box_min, box_max):
    """Slab-method AABB test (compute.glsl:280-294). Returns (t1, t2, ok).

    Axis-parallel rays divide by zero into +-inf, exactly like GLSL IEEE
    semantics; the min/max folds then discard the infinite slabs."""
    t0s = (box_min - origin) / direction
    t1s = (box_max - origin) / direction
    tsm = v3map(jnp.minimum, t0s, t1s)
    tbg = v3map(jnp.maximum, t0s, t1s)
    t1 = jnp.maximum(FLOAT_MIN, jnp.maximum(tsm[0], jnp.maximum(tsm[1], tsm[2])))
    t2 = jnp.minimum(FLOAT_MAX, jnp.minimum(tbg[0], jnp.minimum(tbg[1], tbg[2])))
    return t1, t2, t1 <= t2


def smallest_positive(t1, t2):
    """GetSmallestPositive (compute.glsl:347-350): assumes t2 >= t1, t2 > 0."""
    return jnp.where(t1 < 0.0, t2, t1)


def sphere_normal(center, radius, surface_pos):
    """(p - c) / r (compute.glsl:316-319)."""
    return (surface_pos - center) / radius


def cuboid_normal(box_min, box_max, surface_pos, eps=KERNEL_EPSILON):
    """Axis-aligned face normal by epsilon proximity (compute.glsl:322-332).

    A face component is active when |abs(p-center) - half| <= eps; corners and
    edges yield normalized diagonals, matching the shader.  The normalize is
    guarded against a zero vector (GLSL UB) by flooring the squared length."""
    half = (box_max - box_min) * 0.5
    cs = surface_pos - (box_max + box_min) * 0.5
    act = v3map(lambda c, h: (jnp.abs(jnp.abs(c) - h) <= eps)
                .astype(jnp.float32), cs, half)
    n = v3map(jnp.sign, cs) * act
    return normalize3(n, eps=np.float32(1e-20))
