"""Device-mesh construction: the framework's parallelism topology.

The reference is single-threaded C with no distribution at all (SURVEY.md
section 2, parallelism inventory); this module is where this design adds
it. Two mesh axes cover the framework's parallel strategies:

  * ``rays``  -- ray/tile data parallelism (the DP analog): the pixel/ray
    wavefront shards across devices, scene replicated. Embarrassingly
    parallel; collectives only appear in gradient psums.
  * ``scene`` -- scene/parameter sharding (the TP/FSDP analog): sphere arrays
    shard across devices and partial hits min-reduce across the axis (ring
    ppermute path in tracer/dist/ring.py) for scenes too large to replicate.

On several hosts, call :func:`init_distributed` first (it wraps
``jax.distributed.initialize``); meshes then span all global devices and XLA
lowers collectives onto the interconnect (NCCL over NVLink between the GPUs
of one host). Every GPU of a host reaches every other at the same rate, so
the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import os

import jax
from jax.sharding import Mesh
import numpy as np

RAY_AXIS = "rays"
SCENE_AXIS = "scene"

_DISTRIBUTED_INITIALIZED = False


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None,
                     process_id: int = None,
                     local_device_ids=None) -> int:
    """Multi-host entry point: join the cluster's process group.

    Wraps ``jax.distributed.initialize`` (SURVEY.md section 5, distributed
    communication backend). After this, ``jax.devices()`` spans every
    process's devices and the meshes below lower collectives onto NCCL.

    Nothing detects a cluster automatically here: give
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, as arguments or as TRACER_COORDINATOR /
    TRACER_NUM_PROCESSES. Single-process runs (CI, one GPU, one host's
    GPUs, CPU meshes) skip initialization entirely. Idempotent. Returns the
    process count.
    """
    global _DISTRIBUTED_INITIALIZED
    env_world = int(os.environ.get("TRACER_NUM_PROCESSES", "0")) or None
    num_processes = num_processes or env_world
    coordinator_address = coordinator_address or os.environ.get(
        "TRACER_COORDINATOR", None)
    # Initialize only when multi-process is explicitly configured (flags or
    # TRACER_* env): a single-process run must stay a no-op
    # (jax.distributed.initialize aborts if any backend already exists).
    single = coordinator_address is None and (num_processes or 1) == 1
    if not _DISTRIBUTED_INITIALIZED and not single:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
        _DISTRIBUTED_INITIALIZED = True
    return jax.process_count()


def ray_mesh(n_devices: int = None) -> Mesh:
    """1-D mesh over the ray axis (pure data parallelism)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (RAY_AXIS,))


def scene_mesh(ray_shards: int = None, scene_shards: int = None) -> Mesh:
    """2-D mesh (rays x scene) for joint ray- and scene-sharding."""
    devs = jax.devices()
    n = len(devs)
    if ray_shards is None and scene_shards is None:
        scene_shards = 2 if n % 2 == 0 and n > 1 else 1
        ray_shards = n // scene_shards
    elif ray_shards is None:
        ray_shards = n // scene_shards
    elif scene_shards is None:
        scene_shards = n // ray_shards
    grid = np.array(devs[: ray_shards * scene_shards]).reshape(
        ray_shards, scene_shards)
    return Mesh(grid, (RAY_AXIS, SCENE_AXIS))
