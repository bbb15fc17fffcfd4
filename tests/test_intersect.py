"""Intersector unit tests including the edge cases from SURVEY.md §4 item 3."""

import numpy as np
import jax.numpy as jnp

from tpt.vecmath import vec3

from tpt.ops.intersect import (ray_sphere, ray_cuboid, smallest_positive,
                               sphere_normal, cuboid_normal)


def v3(x, y, z):
    return vec3([x], [y], [z])  # batch shape (1,)


def test_sphere_hit_from_outside():
    t1, t2, ok = ray_sphere(v3(0, 0, 0), v3(0, 0, -1), v3(0, 0, -5), jnp.float32(1.0))
    assert bool(ok[0])
    np.testing.assert_allclose(float(t1[0]), 4.0, atol=1e-5)
    np.testing.assert_allclose(float(t2[0]), 6.0, atol=1e-5)
    assert float(smallest_positive(t1, t2)[0]) == float(t1[0])


def test_sphere_from_inside():
    """Ray origin inside the sphere: t1 < 0 < t2, smallest-positive is t2."""
    t1, t2, ok = ray_sphere(v3(0, 0, -5), v3(0, 0, -1), v3(0, 0, -5), jnp.float32(2.0))
    assert bool(ok[0])
    assert float(t1[0]) < 0 < float(t2[0])
    t = smallest_positive(t1, t2)
    assert float(t[0]) == float(t2[0])  # -> FromInside


def test_sphere_miss():
    _, _, ok = ray_sphere(v3(0, 0, 0), v3(0, 1, 0), v3(5, 0, 0), jnp.float32(1.0))
    assert not bool(ok[0])


def test_sphere_grazing():
    t1, t2, ok = ray_sphere(v3(1, 0, 0), v3(0, 0, -1), v3(0, 0, -5), jnp.float32(1.0))
    assert bool(ok[0])
    np.testing.assert_allclose(float(t1[0]), float(t2[0]), atol=1e-3)


def test_cuboid_basic():
    t1, t2, ok = ray_cuboid(v3(0, 0, 0), v3(0, 0, -1),
                            v3(-1, -1, -4), v3(1, 1, -2))
    assert bool(ok[0])
    np.testing.assert_allclose(float(t1[0]), 2.0, atol=1e-6)
    np.testing.assert_allclose(float(t2[0]), 4.0, atol=1e-6)


def test_cuboid_axis_parallel_ray():
    """Direction components equal to zero must produce inf slabs, not NaN
    (compute.glsl:285-286 relies on IEEE division)."""
    t1, t2, ok = ray_cuboid(v3(0.5, 0.5, 0), v3(0, 0, -1),
                            v3(0, 0, -4), v3(1, 1, -2))
    assert bool(ok[0])
    np.testing.assert_allclose(float(t1[0]), 2.0, atol=1e-6)
    np.testing.assert_allclose(float(t2[0]), 4.0, atol=1e-6)


def test_cuboid_miss_parallel_outside():
    _, _, ok = ray_cuboid(v3(5, 0.5, 0), v3(0, 0, -1),
                          v3(0, 0, -4), v3(1, 1, -2))
    assert not bool(ok[0])


def test_cuboid_inside():
    t1, t2, ok = ray_cuboid(v3(0.5, 0.5, -3), v3(0, 0, -1),
                            v3(0, 0, -4), v3(1, 1, -2))
    assert bool(ok[0])
    assert float(t1[0]) < 0 < float(t2[0])


def test_sphere_normal_unit():
    n = sphere_normal(v3(0, 0, -5), jnp.float32(2.0), v3(0, 2, -5))
    np.testing.assert_allclose(np.asarray(n)[:, 0], (0, 1, 0), atol=1e-6)


def test_cuboid_normal_faces():
    mn, mx = v3(-1, -1, -1), v3(1, 1, 1)
    n = cuboid_normal(mn, mx, v3(1.0, 0.3, 0.2))
    np.testing.assert_allclose(np.asarray(n)[:, 0], (1, 0, 0), atol=1e-6)
    n = cuboid_normal(mn, mx, v3(0.3, -1.0, 0.2))
    np.testing.assert_allclose(np.asarray(n)[:, 0], (0, -1, 0), atol=1e-6)


def test_cuboid_normal_edge_is_diagonal():
    mn, mx = v3(-1, -1, -1), v3(1, 1, 1)
    n = np.asarray(cuboid_normal(mn, mx, v3(1.0, 1.0, 0.0)))[:, 0]
    np.testing.assert_allclose(n, (1 / np.sqrt(2), 1 / np.sqrt(2), 0), atol=1e-5)
