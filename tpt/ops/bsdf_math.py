"""BSDF building blocks: Fresnel, reflect, refract.

(reference: res/shaders/PathTracing/compute.glsl:184-224,359-364)
"""

from __future__ import annotations

import jax.numpy as jnp

from ..vecmath import dot3, sqrt_clamped_grad, where3


def fresnel_schlick(cos_theta, n1, n2):
    """Schlick approximation (compute.glsl:359-364)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    m = 1.0 - cos_theta
    # pow(1-cos, 5) — computed as multiplications for exactness/speed
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def reflect3(incident, normal):
    """GLSL reflect: I - 2*dot(N, I)*N."""
    return incident - 2.0 * dot3(normal, incident) * normal


def refract3(incident, normal, eta):
    """GLSL refract: returns (direction Vec3, tir_mask bool[...]).

    On total internal reflection GLSL returns vec3(0); we return the zero
    vector too (and the mask, so callers can implement a defined TIR policy
    where the reference shader hits UB)."""
    n_dot_i = dot3(normal, incident)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    tir = k < 0.0
    # sqrt guard is 1.0 on TIR lanes; the derivative clamp additionally
    # keeps the k -> 0+ grazing boundary finite (tpt.vecmath)
    sq = sqrt_clamped_grad(jnp.where(tir, 1.0, jnp.maximum(k, 0.0)))
    out = eta * incident - (eta * n_dot_i + sq) * normal
    return where3(tir, 0.0, out), tir
