"""Sharded rendering / training tests on the simulated 8-device CPU mesh.

Exercises the same shard_map/psum code paths as a real multi-card mesh
(SURVEY.md §4 item 4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpt import camera
from tpt.config import CameraConfig, RenderConfig
from tpt.env import constant_environment
from tpt.parallel import make_dist_renderer, make_mesh, make_train_step
from tpt.reference import render_fields
from tpt.scene import cornell_scene

ENV = (0.3, 0.45, 0.6)


def setup(width=32, height=16):
    cam = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                       focal_length=8.0, aperture_diameter=0.1)
    scene = cornell_scene().build()
    inv_p, inv_v, pos = camera.camera_matrices(cam, width, height)
    env = constant_environment(ENV)
    return cam, scene, inv_p, inv_v, pos, env


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    mesh = make_mesh(dp=4, sp=2)
    assert mesh.shape["dp"] == 4 and mesh.shape["sp"] == 2
    with pytest.raises(ValueError):
        make_mesh(dp=3, sp=2)


def test_dp_sharding_bit_exact():
    """Pixel-row sharding must reproduce the single-device image exactly:
    seeds depend only on absolute pixel coordinates."""
    cam, scene, inv_p, inv_v, pos, env = setup()
    cfg = RenderConfig(width=32, height=16, ray_depth=4, spp=1)
    mesh = make_mesh(dp=8, sp=1)
    render = make_dist_renderer(mesh, cfg)
    got, rays = render(scene, env, inv_p, inv_v, cam.focal_length,
                       cam.aperture_diameter, 0)
    want, rays_ref = render_fields(
        scene, env, inv_p, inv_v, pos, jnp.int32(0),
        jnp.float32(cam.focal_length), jnp.float32(cam.aperture_diameter),
        width=32, height=16, ray_depth=4, spp=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(rays) == int(rays_ref)


def test_dp_sharding_nondivisible_rows():
    cam, scene, inv_p, inv_v, pos, env = setup(width=16, height=11)
    cfg = RenderConfig(width=16, height=11, ray_depth=3, spp=1)
    mesh = make_mesh(dp=4, sp=2)
    render = make_dist_renderer(mesh, cfg)
    got, _ = render(scene, env, inv_p, inv_v, cam.focal_length,
                    cam.aperture_diameter, 0)
    assert got.shape == (11, 16, 3)
    assert np.isfinite(np.asarray(got)).all()


def test_sp_sharding_reduces_variance():
    """More sample groups over sp -> lower noise (unbiased mean)."""
    cam, scene, inv_p, inv_v, pos, env = setup()
    cfg = RenderConfig(width=32, height=16, ray_depth=4, spp=1)
    mesh = make_mesh(dp=2, sp=4)
    render = make_dist_renderer(mesh, cfg)
    a, _ = render(scene, env, inv_p, inv_v, cam.focal_length,
                  cam.aperture_diameter, 0)
    b, _ = render(scene, env, inv_p, inv_v, cam.focal_length,
                  cam.aperture_diameter, 1)
    noise_4 = float(jnp.std(a - b))

    mesh1 = make_mesh(dp=8, sp=1)
    render1 = make_dist_renderer(mesh1, cfg)
    c, _ = render1(scene, env, inv_p, inv_v, cam.focal_length,
                   cam.aperture_diameter, 0)
    d, _ = render1(scene, env, inv_p, inv_v, cam.focal_length,
                   cam.aperture_diameter, 1)
    noise_1 = float(jnp.std(c - d))
    assert noise_4 < noise_1  # 4 sample groups vs 1

    # and the sp-sharded estimate converges to the same mean
    est4 = float(jnp.mean(a))
    est1 = float(jnp.mean(c))
    assert abs(est4 - est1) < 0.15


def test_train_step_descends():
    """Recover an emissive perturbation by pixel-gradient descent.

    Emission is the smooth axis of the renderer (it never enters throughput,
    lobe selection, or Russian roulette), so plain SGD must recover it;
    albedo-axis recovery also works but is noisier because throughput
    changes flip discrete RR decisions (the documented detached-decision
    gradient bias)."""
    cam, scene, inv_p, inv_v, pos, env = setup()
    cfg = RenderConfig(width=32, height=16, ray_depth=3, spp=1)
    mesh = make_mesh(dp=4, sp=2)
    render = make_dist_renderer(mesh, cfg)
    target, _ = render(scene, env, inv_p, inv_v, cam.focal_length,
                       cam.aperture_diameter, 0)

    import dataclasses
    true_emissive = np.asarray(scene.sphere_material)[3, 4:7].copy()
    perturbed = dataclasses.replace(
        scene,
        sphere_material=scene.sphere_material.at[3, 4:7].mul(0.4),
    )
    mask = (jnp.zeros_like(scene.sphere_material).at[3, 4:7].set(1.0),
            jnp.zeros_like(scene.cuboid_material))
    step = make_train_step(mesh, cfg, counts=(4, 0), param_mask=mask)
    losses = []
    s = perturbed
    for it in range(20):
        s, loss = step(s, env, inv_p, inv_v, cam.focal_length,
                       cam.aperture_diameter, 0, target, 20.0)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.01, losses
    got_emissive = np.asarray(s.sphere_material)[3, 4:7]
    np.testing.assert_allclose(got_emissive, true_emissive, rtol=0.02)
    # geometry untouched by the optimizer
    np.testing.assert_array_equal(np.asarray(s.sphere_pos_radius),
                                  np.asarray(scene.sphere_pos_radius))


def test_kernel_and_oracle_backends_agree():
    """The production (Pallas kernel, blocked env) and test (XLA oracle,
    planar env) dist backends produce identical sharded frames."""
    cam, scene, inv_p, inv_v, pos, env = setup()
    cfg = RenderConfig(width=32, height=16, ray_depth=4, spp=1)
    mesh = make_mesh(dp=4, sp=2)
    got_k, rays_k = make_dist_renderer(mesh, cfg, backend="kernel")(
        scene, env, inv_p, inv_v, cam.focal_length, cam.aperture_diameter, 1)
    got_o, rays_o = make_dist_renderer(mesh, cfg, backend="oracle")(
        scene, env, inv_p, inv_v, cam.focal_length, cam.aperture_diameter, 1)
    np.testing.assert_allclose(np.asarray(got_k), np.asarray(got_o),
                               rtol=1e-6, atol=1e-6)
    assert int(rays_k) == int(rays_o)


def test_dp_sharded_center_jitter_bit_exact(monkeypatch):
    """cfg.jitter must reach the kernel inside the sharded paths: a
    dp-sharded jitter='center' render is bit-exact to the single-chip
    center render (the r3 bug: dist.py dropped cfg.jitter, silently
    rendering corner-jitter whenever dp/sp > 1).

    Bitwise image comparisons cannot detect the dropped flag on this
    backend — XLA:CPU rounds the corner and center NDC expressions
    identically at every config probed (the modes are algebraically equal;
    tests/test_jitter.py quantifies the ulp-level delta where it exists) —
    so the kernel-argument value is captured directly as well."""
    from tpt.kernels import trace as trace_mod

    seen = []
    real = trace_mod.pallas_trace

    def spy(*args, **kwargs):
        seen.append(kwargs.get("jitter", "corner"))
        return real(*args, **kwargs)

    monkeypatch.setattr(trace_mod, "pallas_trace", spy)
    cam = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                       focal_length=8.0, aperture_diameter=0.05)
    from tpt.scene import cornell_scene as _cs
    scene = _cs().build()
    inv_p, inv_v, pos = camera.camera_matrices(cam, 32, 32)
    env = constant_environment((0.4, 0.5, 0.7))
    cfg = RenderConfig(width=32, height=32, ray_depth=3, spp=2,
                      jitter="center")
    mesh = make_mesh(dp=8, sp=1)
    render = make_dist_renderer(mesh, cfg)
    got, _ = render(scene, env, inv_p, inv_v, cam.focal_length,
                    cam.aperture_diameter, 0)
    want, _ = render_fields(
        scene, env, inv_p, inv_v, pos, jnp.int32(0),
        jnp.float32(cam.focal_length), jnp.float32(cam.aperture_diameter),
        width=32, height=32, ray_depth=3, spp=2, jitter="center")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert seen and all(j == "center" for j in seen)


def test_train_step_honors_center_jitter(monkeypatch):
    """The sharded training path must forward cfg.jitter to trace_diff
    (scalar-loss comparisons can't detect the flag: the two modes differ
    only at ulp level, below f32 loss resolution at this size — so capture
    the argument that actually reaches the differentiable trace)."""
    from tpt.kernels import trace_grad

    seen = []
    real = trace_grad.trace_diff

    def spy(scene, inv_p, inv_v, frame, focal, aperture, row0,
            width, height, ray_depth, spp, counts, n_rows=None,
            jitter="corner", rr=True):
        seen.append(jitter)
        return real(scene, inv_p, inv_v, frame, focal, aperture, row0,
                    width, height, ray_depth, spp, counts, n_rows, jitter, rr)

    monkeypatch.setattr(trace_grad, "trace_diff", spy)
    cam, scene, inv_p, inv_v, pos, env = setup()
    target = jnp.zeros((16, 32, 3), jnp.float32) + 0.25
    cfg = RenderConfig(width=32, height=16, ray_depth=3, spp=1,
                      jitter="center")
    mesh = make_mesh(dp=4, sp=2)
    step = make_train_step(mesh, cfg, counts=(4, 5), backend="kernel")
    _, loss = step(scene, env, inv_p, inv_v, cam.focal_length,
                   cam.aperture_diameter, 0, target, 0.0)
    assert np.isfinite(float(loss))
    assert seen and all(j == "center" for j in seen)


def test_train_step_rr_off_backends_agree():
    """Fixed-depth (russian_roulette=False) sharded training: kernel and
    oracle backends must compute the same loss (the inverse-rendering
    configuration — see tpt.integrator.bounce_step on why RR'd transport
    cannot recover albedo scale)."""
    cam, scene, inv_p, inv_v, pos, env = setup()
    target = jnp.zeros((16, 32, 3), jnp.float32) + 0.25
    losses = {}
    for backend in ("kernel", "oracle"):
        cfg = RenderConfig(width=32, height=16, ray_depth=3, spp=1)
        mesh = make_mesh(dp=4, sp=2)
        step = make_train_step(mesh, cfg, counts=(4, 5), backend=backend,
                               russian_roulette=False)
        new_scene, loss = step(scene, env, inv_p, inv_v, cam.focal_length,
                               cam.aperture_diameter, 0, target, 0.01)
        losses[backend] = float(loss)
        assert np.isfinite(losses[backend])
    np.testing.assert_allclose(losses["kernel"], losses["oracle"], rtol=1e-5)


def test_train_step_grads_kernel_vs_oracle_demo_scene():
    """Demo-scene (48, 7) gradient parity across backends on the virtual
    mesh: with lr=1 one bare-SGD step writes (old - grad) into the material
    tables, so comparing the stepped tables compares the full psum'd
    gradients of the sharded loss — kernel-forward step vs oracle AD."""
    from tpt.scene import demo_scene
    scene = demo_scene().build()
    cam = CameraConfig()
    cfg = RenderConfig(width=32, height=16, ray_depth=3, spp=1)
    inv_p, inv_v, _ = camera.camera_matrices(cam, cfg.width, cfg.height)
    env = constant_environment(ENV)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32) + 0.25
    grads = {}
    for backend in ("kernel", "oracle"):
        mesh = make_mesh(dp=4, sp=2)
        step = make_train_step(mesh, cfg, counts=(48, 7), backend=backend,
                               russian_roulette=False)
        new_scene, loss = step(scene, env, inv_p, inv_v, cam.focal_length,
                               cam.aperture_diameter, 0, target, 1.0)
        gs = np.asarray(scene.sphere_material) - np.asarray(
            new_scene.sphere_material)
        gc = np.asarray(scene.cuboid_material) - np.asarray(
            new_scene.cuboid_material)
        assert np.isfinite(gs).all() and np.isfinite(gc).all()
        grads[backend] = (gs, gc, float(loss))
    np.testing.assert_allclose(grads["kernel"][2], grads["oracle"][2],
                               rtol=1e-5)
    for k in range(2):
        w, g = grads["oracle"][k], grads["kernel"][k]
        atol = 3e-4 * max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(g, w, rtol=3e-4, atol=atol)


def test_banded_psum_grads_match_single_psum():
    """psum_bands > 1 restructures the gradient all-reduce into per-sub-band
    collectives (the overlap configuration); the resulting gradients
    must match the autodiff-placed single psum."""
    cam, scene, inv_p, inv_v, pos, env = setup()
    cfg = RenderConfig(width=32, height=16, ray_depth=3, spp=1)
    target = jnp.zeros((16, 32, 3), jnp.float32) + 0.25
    stepped = {}
    for bands in (1, 2):
        mesh = make_mesh(dp=4, sp=2)
        step = make_train_step(mesh, cfg, counts=(4, 5),
                               russian_roulette=False, psum_bands=bands)
        new_scene, loss = step(scene, env, inv_p, inv_v, cam.focal_length,
                               cam.aperture_diameter, 0, target, 1.0)
        stepped[bands] = (np.asarray(new_scene.sphere_material),
                         np.asarray(new_scene.cuboid_material), float(loss))
    np.testing.assert_allclose(stepped[1][2], stepped[2][2], rtol=1e-6)
    # sub-band summation reorders float adds; tolerance, not bitwise
    np.testing.assert_allclose(stepped[2][0], stepped[1][0],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(stepped[2][1], stepped[1][1],
                               rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        make_train_step(make_mesh(dp=4, sp=2), cfg, counts=(4, 5),
                        psum_bands=3)  # 4 local rows not divisible by 3


def test_dist_progressive_matches_single_chip():
    """The sharded progressive block renderer (refill kernel per row band,
    frames sharded over sp) must reproduce the single-chip refill block to
    psum-reorder tolerance, and fold the running mean identically."""
    from tpt import init_accumulator
    from tpt.env import pack_block_table
    from tpt.kernels.render import progressive_frames
    from tpt.parallel import make_dist_progressive
    cam, scene, inv_p, inv_v, pos, env = setup(width=128, height=16)
    cfg = RenderConfig(width=128, height=16, ray_depth=3, spp=1)
    table = pack_block_table(env)
    F = 4

    single = init_accumulator(16, 128)
    single, rays_s = progressive_frames(
        single, scene, table, inv_p, inv_v, jnp.int32(0),
        jnp.float32(cam.focal_length), jnp.float32(cam.aperture_diameter),
        width=128, height=16, ray_depth=3, spp=1, n_frames=F, refill=True)

    mesh = make_mesh(dp=4, sp=2)
    render = make_dist_progressive(mesh, cfg, n_frames=F)
    acc = init_accumulator(16, 128)
    acc, rays = render(acc, scene, table, inv_p, inv_v, cam.focal_length,
                       cam.aperture_diameter, 0)
    assert int(rays) == int(rays_s)
    assert int(acc.frame) == F
    np.testing.assert_allclose(np.asarray(acc.image),
                               np.asarray(single.image),
                               rtol=1e-5, atol=1e-6)

    # a second block continues the running mean identically
    single, _ = progressive_frames(
        single, scene, table, inv_p, inv_v, jnp.int32(F),
        jnp.float32(cam.focal_length), jnp.float32(cam.aperture_diameter),
        width=128, height=16, ray_depth=3, spp=1, n_frames=F, refill=True)
    acc, _ = render(acc, scene, table, inv_p, inv_v, cam.focal_length,
                    cam.aperture_diameter, F)
    np.testing.assert_allclose(np.asarray(acc.image),
                               np.asarray(single.image),
                               rtol=1e-5, atol=1e-6)
