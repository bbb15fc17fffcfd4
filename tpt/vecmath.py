"""Vec3 helpers.

A vector is a :class:`Vec3` — three same-shaped component arrays — so that
every value in the integrator is a plain per-lane array: XLA fuses the three
components like any other elementwise field, and a Pallas GPU kernel keeps
each one in registers as a power-of-two block (Triton has no tensors of
extent 3).  Arithmetic operators work componentwise, with scalars and
per-lane arrays broadcasting over the components.  :func:`stack3` and
:func:`unstack3` convert to and from the ``f32[3, *batch]`` layout used at
the module boundaries (trace results, environment lookups).

``dot3``, ``normalize3`` and ``max3`` index components, so they accept the
stacked layout as well.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


@jax.custom_jvp
def sqrt_clamped_grad(x):
    """sqrt with a bit-identical primal but a derivative clamped near 0.

    sqrt'(0) is infinite; at measure-zero points (grazing intersections,
    the refract TIR boundary) the transpose multiplies that infinity by a
    zero cotangent and poisons whole gradient tables with NaN.  The clamp
    0.5/sqrt(max(x, 1e-12)) only changes the derivative where it was
    unusable anyway — the standard differentiable-renderer hygiene."""
    return jnp.sqrt(x)


@sqrt_clamped_grad.defjvp
def _sqrt_clamped_grad_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    primal = jnp.sqrt(x)
    return primal, t * (0.5 / jnp.sqrt(jnp.maximum(x, 1e-12)))


def _parts(v):
    return v if isinstance(v, Vec3) else (v, v, v)


class Vec3(NamedTuple):
    """Three component arrays of one shape; a pytree."""
    x: jax.Array
    y: jax.Array
    z: jax.Array

    # NumPy scalars must defer to the reflected operators below instead of
    # treating the tuple as a sequence
    __array_ufunc__ = None

    def _op(self, other, f):
        o = _parts(other)
        return Vec3(f(self.x, o[0]), f(self.y, o[1]), f(self.z, o[2]))

    def _rop(self, other, f):
        o = _parts(other)
        return Vec3(f(o[0], self.x), f(o[1], self.y), f(o[2], self.z))

    def __add__(self, other):
        return self._op(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._rop(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._op(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._rop(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._op(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._rop(other, lambda a, b: a * b)

    def __truediv__(self, other):
        return self._op(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._rop(other, lambda a, b: a / b)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def v3map(f, *vs):
    """Apply an elementwise ``f`` per component; non-Vec3 arguments are
    shared by all three components."""
    return Vec3(*(f(*(_parts(v)[i] for v in vs)) for i in range(3)))


def vec3(x, y, z):
    x = jnp.asarray(x, jnp.float32)
    return Vec3(x, jnp.broadcast_to(jnp.asarray(y, jnp.float32), x.shape),
                jnp.broadcast_to(jnp.asarray(z, jnp.float32), x.shape))


def splat3(components, batch_shape):
    """Broadcast three scalars to a Vec3 of ``batch_shape`` arrays."""
    return Vec3(*(jnp.broadcast_to(jnp.asarray(c, jnp.float32),
                                   tuple(batch_shape))
                  for c in components))


def stack3(v) -> jax.Array:
    """Vec3 -> f32[3, *batch]."""
    return jnp.stack(list(v))


def unstack3(a) -> Vec3:
    """f32[3, *batch] -> Vec3."""
    return Vec3(a[0], a[1], a[2])


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return Vec3(a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])


def length3(a):
    return jnp.sqrt(dot3(a, a))


def normalize3(a, eps=None):
    """Unit vector. With ``eps`` set, guards the degenerate zero-vector case
    by flooring the squared length (documented deviation from GLSL's UB)."""
    d = dot3(a, a)
    if eps is not None:
        d = jnp.maximum(d, eps)
    return a / jnp.sqrt(d)


def where3(cond, a, b):
    return v3map(lambda x, y: jnp.where(cond, x, y), a, b)


def max3(a):
    return jnp.maximum(a[0], jnp.maximum(a[1], a[2]))


def min3(a):
    return jnp.minimum(a[0], jnp.minimum(a[1], a[2]))


def mix3(a, b, t):
    """GLSL mix: a*(1-t) + b*t, computed exactly as a + (b-a)*t."""
    return a + (b - a) * t


def mix(a, b, t):
    return a + (b - a) * t
