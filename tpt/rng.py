"""Counter-free PCG hash RNG, bit-compatible with the reference shader.

The reference chains a PCG hash through a mutable per-pixel uint32 seed
(reference: res/shaders/PathTracing/compute.glsl:334-344):

    seed = seed * 747796405u + 2891336453u;
    word = ((seed >> ((seed >> 28u) + 4u)) ^ seed) * 277803737u;
    return (word >> 22u) ^ word;           // value; `seed` is the new state
    float01 = value / 4294967296.0;

and seeds each pixel with
``x*1973 + y*9277 + frame*2699 | 1`` (compute.glsl:106).

Here the chain is functional: every draw takes a uint32 seed (any shape) and
returns ``(value, new_seed)``.  All arithmetic is uint32 with wraparound, so a
JAX run reproduces the shader's stream bit for bit.  The same code runs inside
the Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_MUL = np.uint32(747796405)
_INC = np.uint32(2891336453)
_OUT_MUL = np.uint32(277803737)

_U32_TO_FLOAT = np.float32(1.0 / 4294967296.0)


def pixel_seed(x, y, frame):
    """Initial per-pixel seed (compute.glsl:106).

    ``|1`` binds *after* the additions (C precedence), so the whole sum is
    OR'd with 1.
    """
    x = jnp.asarray(x, jnp.uint32)
    y = jnp.asarray(y, jnp.uint32)
    frame = jnp.asarray(frame, jnp.uint32)
    return (x * np.uint32(1973) + y * np.uint32(9277) + frame * np.uint32(2699)) | np.uint32(1)


def pcg_hash(seed):
    """One PCG step. Returns ``(word, new_seed)``, both uint32."""
    seed = seed * _MUL + _INC
    shift = (seed >> np.uint32(28)) + np.uint32(4)
    word = ((seed >> shift) ^ seed) * _OUT_MUL
    return (word >> np.uint32(22)) ^ word, seed


def u32_to_f32(u):
    """Exact uint32 -> float32 value conversion (round-to-nearest like a
    native cast), written as int32 casts only, which every backend lowers.
    hi*65536 is exact, and the single add performs the same
    correctly-rounded step as a direct conversion would."""
    hi = (u >> np.uint32(16)).astype(jnp.int32).astype(jnp.float32)
    lo = (u & np.uint32(0xFFFF)).astype(jnp.int32).astype(jnp.float32)
    return hi * np.float32(65536.0) + lo


def random_float01(seed):
    """One draw in [0, 1). Returns ``(f32 value, new_seed)``."""
    word, seed = pcg_hash(seed)
    return u32_to_f32(word) * _U32_TO_FLOAT, seed


def random_floats(seed, n: int):
    """``n`` sequential draws. Returns ``(list of f32 values, new_seed)``."""
    out = []
    for _ in range(n):
        value, seed = random_float01(seed)
        out.append(value)
    return out, seed


def np_pcg_hash(seed: int) -> tuple[int, int]:
    """Pure-NumPy scalar reference of one PCG step (for tests / native parity)."""
    with np.errstate(over="ignore"):
        s = np.uint32(seed) * _MUL + _INC
        shift = (s >> np.uint32(28)) + np.uint32(4)
        word = ((s >> shift) ^ s) * _OUT_MUL
        return int((word >> np.uint32(22)) ^ word), int(s)
