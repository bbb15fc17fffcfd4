"""Multi-host bootstrap.

The reference is a single-process, single-GPU app (SURVEY.md §2.3 — absence
verified across all 23 C# files); this module is the from-scratch multi-host
story:

  * ``init_distributed()`` wraps ``jax.distributed.initialize`` with
    fail-fast validation, so every process joins the same job and agrees on
    the global device count before any mesh is built;
  * ``make_host_mesh()`` builds the ('dp', 'sp') mesh host-aware: the ``dp``
    (pixel-band) axis runs *across* hosts — each host renders a horizontal
    band of the image and the only inter-host traffic is the tiny gradient /
    ray-count psum — while the ``sp`` (sample-group) axis stays *inside* a
    host, where its O(H*W/dp) psum-mean runs over the cards' own links.

Run recipe (N processes, one per host):

    python -c "
    from tpt.parallel.init import init_distributed, make_host_mesh
    from tpt.parallel import make_dist_renderer
    init_distributed('host0:8476', num_processes=N, process_id=RANK)
    mesh = make_host_mesh(sp=1)              # dp = all cards, across hosts
    render = make_dist_renderer(mesh, cfg)   # each host computes its band
    "

Single-process usage degenerates gracefully: ``init_distributed()`` is a
no-op when no coordinator is configured and exactly one process exists, and
``make_host_mesh`` then equals ``make_mesh``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join (or create) the multi-host job.  Returns the process count.

    With no arguments, relies on ``jax.distributed``'s automatic discovery
    of a cluster the runtime describes (e.g. SLURM); a plain machine
    describes none, so pass the coordinator explicitly there:

        init_distributed("10.0.0.1:8476", num_processes=4, process_id=rank)

    Fail-fast checks (the analogue of the reference's GL capability
    preconditions, src/MainWindow.cs:152-162):
      * a second call with different topology raises;
      * after initialization, the global device list must be non-empty and
        divisible by the local device count (homogeneous hosts).
    """
    global _initialized
    explicit = coordinator_address is not None
    if explicit and (num_processes is None or process_id is None):
        raise ValueError(
            "explicit init needs coordinator_address, num_processes and "
            "process_id together")

    if not explicit and jax.process_count() == 1 and not _initialized:
        # Single process, nothing to coordinate: the degenerate (and test)
        # case.  jax.distributed.initialize() would try to guess a
        # coordinator and fail on machines that describe no cluster.
        _validate_topology()
        return 1

    if not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        _initialized = True
    _validate_topology()
    return jax.process_count()


def _validate_topology() -> None:
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    if n_global == 0:
        raise RuntimeError("no devices visible after distributed init")
    if n_global % max(n_local, 1):
        raise RuntimeError(
            f"heterogeneous hosts: {n_global} global devices not divisible "
            f"by {n_local} local devices")
    if n_local * jax.process_count() != n_global:
        raise RuntimeError(
            f"device/process mismatch: {jax.process_count()} processes x "
            f"{n_local} local devices != {n_global} global devices")


def make_host_mesh(sp: int = 1, devices=None) -> Mesh:
    """('dp', 'sp') mesh with dp spanning hosts and sp contained in a host.

    ``jax.devices()`` orders devices process-major, so reshaping to
    (n_hosts * cards_per_host / sp, sp) keeps every sp-group of cards inside
    one process as long as ``sp`` divides the per-host card count — which we
    validate fail-fast.  The resulting traffic pattern: the sp psum-mean of
    sample groups stays inside a host; only dp-axis reductions (scalar ray
    counts, parameter gradients) cross between hosts.
    """
    explicit = devices is not None
    devices = list(devices) if explicit else list(jax.devices())
    n = len(devices)
    if explicit:
        # group explicit lists by their actual owning process, not by
        # process-count division: a heterogeneous hand-picked list (e.g. 3
        # cards from host A + 1 from host B) must not silently pass the
        # in-host check below
        from collections import Counter
        owners = Counter(getattr(d, "process_index", 0) for d in devices)
        per_host = min(owners.values())
        if len(set(owners.values())) > 1 and sp > 1:
            raise ValueError(
                f"explicit device list is host-imbalanced {dict(owners)}; "
                "sp>1 needs equal cards per host so sample-group psums "
                "stay inside a host")
    else:
        per_host = max(len(jax.local_devices()), 1)
    per_host = per_host or n
    if sp <= 0 or n % sp:
        raise ValueError(f"sp={sp} must divide {n} devices")
    n_hosts = (len({getattr(d, "process_index", 0) for d in devices})
               if explicit else jax.process_count())
    if n_hosts > 1 and per_host % sp:
        raise ValueError(
            f"sp={sp} must divide the per-host device count {per_host} so "
            "sample-group psums stay inside a host")
    dp = n // sp
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))
