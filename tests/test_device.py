"""Where the kernels run, where the compile cache lives, and what the
entry points do without a GPU.

The kernels compile for the GPU only; the suite runs them in the Pallas
interpreter because conftest asks for it explicitly.  Without that request
every kernel entry point must refuse the CPU rather than fall back.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from tpt import camera
from tpt.config import CameraConfig
from tpt.kernels import device
from tpt.scene import cornell_scene, demo_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_interpret(monkeypatch):
    monkeypatch.setattr(device, "_interpret", False)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


def test_decision_interprets_only_on_request(no_interpret):
    assert device.use_interpreter(True) is True
    with pytest.raises(RuntimeError, match=r"'cpu'.*--backend oracle"):
        device.use_interpreter()
    with pytest.raises(RuntimeError):
        device.use_interpreter(False)
    device.set_interpret(True)
    assert device.interpret_requested() and device.use_interpreter()


@pytest.mark.parametrize("entry", ["trace", "progressive", "render"])
def test_kernel_entry_points_raise_off_gpu(no_interpret, entry):
    from tpt.kernels.render import render_fields
    from tpt.kernels.trace import pallas_trace, pallas_trace_progressive
    from tpt.env import constant_environment
    cam = CameraConfig()
    scene = cornell_scene().build()
    # a shape no other test compiles: the check runs while tracing
    inv_p, inv_v, pos = camera.camera_matrices(cam, 7, 5)
    shape = dict(width=7, height=5, ray_depth=2, spp=1)
    with pytest.raises(RuntimeError, match="GPU only"):
        if entry == "trace":
            pallas_trace(scene, inv_p, inv_v, 0, 8.0, 0.1, **shape)
        elif entry == "progressive":
            pallas_trace_progressive(scene, inv_p, inv_v, 0, 8.0, 0.1,
                                     n_frames=2, **shape)
        else:
            render_fields(scene, constant_environment((1.0, 1.0, 1.0)),
                          inv_p, inv_v, pos, jnp.int32(0),
                          jnp.float32(8.0), jnp.float32(0.1), **shape)


def test_cli_kernel_backend_refuses_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "tpt.cli", "render", "--width", "8",
         "--height", "8", "--frames", "1", "--backend", "kernel",
         "--platform", "cpu", "--out", os.devnull],
        capture_output=True, text=True, cwd=REPO, env=_cpu_env(),
        timeout=300)
    assert r.returncode != 0
    assert "--backend oracle" in r.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_fail_without_gpu(script):
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, cwd=REPO,
                       env=_cpu_env(), timeout=300)
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout and "Mrays" not in r.stdout
    assert "no GPU" in r.stderr


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    from tpt.utils import cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert cache.cache_dir() == str(tmp_path)
    # JAX reads the variable itself; the code sets nothing else
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch):
    from tpt.utils import cache
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_persistent_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _lower_for_cuda(fn, *args, **kwargs):
    """Lower a jitted kernel wrapper for CUDA without a card: runs the
    Pallas -> Triton IR lowering (unsupported primitives, shapes and
    indexing fail here); only Triton's own compile is left to the card."""
    exported = jax.export.export(
        jax.jit(lambda *a: fn(*a, **kwargs)), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    return exported.mlir_module()


@pytest.mark.parametrize("kernel", ["per_frame", "refill"])
def test_kernels_lower_through_triton(kernel):
    from tpt.kernels import trace
    cam = CameraConfig()
    scene = demo_scene().build()
    inv_p, inv_v, _ = camera.camera_matrices(cam, 64, 32)
    common = (scene, inv_p, inv_v, jnp.int32(0), jnp.float32(20.0),
              jnp.float32(0.14))
    static = dict(width=64, height=32, ray_depth=13, spp=2,
                  interpret=False, counts=(48, 7), n_rows=32,
                  jitter="corner", rr=True)
    if kernel == "per_frame":
        text = _lower_for_cuda(trace._pallas_trace, *common, jnp.int32(0),
                               **static)
    else:
        text = _lower_for_cuda(trace._pallas_trace_progressive, *common,
                               jnp.int32(3), jnp.int32(0), n_frames=3,
                               **static)
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "tpt_trace"' in text
