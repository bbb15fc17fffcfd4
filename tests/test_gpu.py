"""On-card checks: each test runs one chip_smoke.py phase on the GPU.

The phase runs in a subprocess, so this process stays on the CPU (see
conftest).  Whether a card is present is decided in a fixture; without one
the tests skip.  Run on a GPU machine with one process, so that only one
JAX process holds the card:

    python -m pytest tests/ -m gpu -p no:xdist
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_env():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no GPU card on this machine")
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


@pytest.mark.parametrize("phase", ["device", "golden", "forward", "train"])
def test_chip_smoke_phase(gpu_env, phase):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--phase",
         phase], capture_output=True, text=True, cwd=REPO, env=gpu_env,
        timeout=1200)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
