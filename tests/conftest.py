"""Test configuration: run on CPU with a simulated 8-device mesh.

Multi-device sharding tests exercise the same psum/shard_map code paths as
a real multi-card mesh, per SURVEY.md §4 item 4.  The Pallas kernels run in
the Pallas interpreter, requested explicitly (tpt.kernels.device): without
that request a kernel entry point refuses to run off the GPU.

Tests marked ``gpu`` need the card; they decide inside a fixture whether
one is present and skip here.  Run them on a GPU machine, one process only
(a JAX process reserves most of the card's memory):

    python -m pytest tests/ -m gpu -p no:xdist
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import matplotlib  # noqa: E402

matplotlib.use("Agg")  # headless widget tests (tests/test_interactive.py)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tpt.kernels import set_interpret  # noqa: E402

set_interpret(True)


@pytest.fixture
def rng_np():
    return np.random.default_rng(1234)
