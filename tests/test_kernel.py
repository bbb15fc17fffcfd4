"""Pallas kernel vs XLA oracle parity (interpreter mode on CPU).

The kernel and oracle share the integrator source, so this validates the
kernel plumbing: pixel blocks and padding, table reads, the rolled
bounce loop, RNG in-kernel.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from tpt import camera
from tpt.config import CameraConfig
from tpt.env import constant_environment
from tpt.kernels.render import render_fields as kernel_render
from tpt.reference import render_fields as oracle_render
from tpt.scene import cornell_scene, demo_scene

ENV = (0.3, 0.45, 0.6)


def run_pair(builder, cam, width, height, frame, ray_depth, spp):
    scene = builder.build()
    inv_p, inv_v, pos = camera.camera_matrices(cam, width, height)
    env_faces = constant_environment(ENV)
    args = (scene, env_faces, inv_p, inv_v, pos, jnp.int32(frame),
            jnp.float32(cam.focal_length), jnp.float32(cam.aperture_diameter))
    kwargs = dict(width=width, height=height, ray_depth=ray_depth, spp=spp)
    a, ra = kernel_render(*args, **kwargs)
    b, rb = oracle_render(*args, **kwargs)
    return np.asarray(a), np.asarray(b), int(ra), int(rb)


def test_kernel_matches_oracle_cornell():
    cam = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                       focal_length=8.0, aperture_diameter=0.1)
    a, b, ra, rb = run_pair(cornell_scene(), cam, 32, 24, 0, 4, 1)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert ra == rb


def test_kernel_matches_oracle_demo():
    cam = CameraConfig()
    a, b, ra, rb = run_pair(demo_scene(), cam, 40, 24, 2, 13, 2)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert ra == rb


def test_kernel_nonaligned_size():
    """Image sizes that don't divide the tile shape exercise padding."""
    cam = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                       focal_length=8.0, aperture_diameter=0.0)
    a, b, _, _ = run_pair(cornell_scene(), cam, 17, 9, 1, 3, 1)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_progressive_frames_matches_manual_loop():
    """The fused multi-frame program (trace -> blocked env fetch ->
    accumulate in one jit) equals frame-by-frame render + accumulate."""
    from tpt.env import pack_block_table
    from tpt.kernels.render import progressive_frames
    from tpt.progressive import init_accumulator, accumulate

    cam = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                       focal_length=8.0, aperture_diameter=0.1)
    width, height, depth, spp = 24, 16, 3, 1
    scene = cornell_scene().build()
    inv_p, inv_v, pos = camera.camera_matrices(cam, width, height)
    env_faces = constant_environment(ENV)

    want = init_accumulator(height, width)
    for f in range(3):
        img, _ = kernel_render(scene, env_faces, inv_p, inv_v, pos,
                               jnp.int32(f), jnp.float32(cam.focal_length),
                               jnp.float32(cam.aperture_diameter),
                               width=width, height=height,
                               ray_depth=depth, spp=spp)
        want = accumulate(want, img)

    got = init_accumulator(height, width)
    got, rays = progressive_frames(
        got, scene, pack_block_table(env_faces), inv_p, inv_v, jnp.int32(0),
        jnp.float32(cam.focal_length), jnp.float32(cam.aperture_diameter),
        width=width, height=height, ray_depth=depth, spp=spp, n_frames=3)

    assert int(got.frame) == int(want.frame) == 3
    assert int(rays) > 0
    np.testing.assert_allclose(np.asarray(got.image), np.asarray(want.image),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width,height,n_rows,row0", [
    (40, 20, 7, 5),     # several blocks, band inside the frame
    (33, 9, 9, 0),      # one partial block, whole frame as a band
    (16, 10, 4, 8),     # band running past the frame: rows clamp
])
def test_wrapper_pads_and_bands(width, height, n_rows, row0):
    """The wrapper pads the flat pixel run to whole blocks and strips the
    padding; a row band equals the matching rows of the whole frame (rows
    past the frame repeat its last row) — seeds depend only on absolute
    pixel coordinates."""
    from tpt.kernels.trace import BLOCK, pallas_trace
    cam = CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                       focal_length=8.0, aperture_diameter=0.1)
    scene = cornell_scene().build()
    inv_p, inv_v, _ = camera.camera_matrices(cam, width, height)
    args = (scene, inv_p, inv_v, jnp.int32(3), jnp.float32(8.0),
            jnp.float32(0.1))
    shape = dict(width=width, height=height, ray_depth=3, spp=2)
    whole = pallas_trace(*args, **shape)
    band = pallas_trace(*args, n_rows=n_rows, row0=row0, **shape)
    assert (width * n_rows) % BLOCK != 0 or n_rows == height
    rows = np.minimum(row0 + np.arange(n_rows), height - 1)
    for name, w, b in zip(whole._fields, whole, band):
        assert w.shape[-2:] == (height, width), name
        assert b.shape == w.shape[:-2] + (n_rows, width), name
        np.testing.assert_array_equal(np.asarray(b),
                                      np.asarray(w)[..., rows, :],
                                      err_msg=name)
