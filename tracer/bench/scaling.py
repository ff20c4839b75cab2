"""Scaling-efficiency harness: rays/s vs device count.

The BASELINE north star asks for >= 85% rays/s scaling efficiency at 2+
hosts. This harness measures closest-hit throughput on sub-meshes of
1, 2, 4, ..., P devices with the scene replicated and rays sharded (DP) --
the framework's primary strategy -- and reports efficiency relative to the
1-device run. It runs identically on a virtual CPU mesh (CI) and a real pod
multi-device host; the reference has no analog
(single-threaded C, SURVEY.md section 2 parallelism inventory).
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax.sharding import Mesh

from tracer.bench.timing import time_calls
from tracer.core.types import Ray
from tracer.dist.mesh import RAY_AXIS
from tracer.dist.shard import nearest_hit_sharded


def measure_scaling(scene, rays: Ray, nearest_hit: Callable,
                    device_counts=None, reps: int = 3) -> list[dict]:
    """Time ``nearest_hit_sharded`` on growing sub-meshes.

    rays: flat ray batch divisible by every device count tested.
    Returns [{devices, ms, mrays_per_s, efficiency}, ...].
    """
    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                         if n <= len(devs)]
    b = rays.origin.reshape(-1, 3).shape[0]
    rows = []
    base = None
    for n in device_counts:
        mesh = Mesh(np.array(devs[:n]), (RAY_AXIS,))
        fn = jax.jit(lambda r, s: nearest_hit_sharded(
            r, s, mesh, nearest_hit).t)
        dt = time_calls(fn, rays, scene, n=reps, warmup=1)[0].median_s
        # Overhead decomposition (VERDICT r4 task 10): time a second,
        # quarter-size batch. With T(n, B) = overhead(n) + work(B)/n the
        # two measurements separate the batch-proportional term from the
        # per-device-count fixed cost:
        #   work_term = (T(B) - T(B/4)) * 4/3 ;  overhead = T(B) - work.
        q = b // 4
        rq = Ray(origin=rays.origin.reshape(-1, 3)[:q],
                 direction=rays.direction.reshape(-1, 3)[:q])
        dtq = time_calls(fn, rq, scene, n=reps, warmup=1)[0].median_s
        work = max((dt - dtq) * 4.0 / 3.0, 0.0)
        overhead = max(dt - work, 0.0)
        mrays = b / dt / 1e6
        if base is None:
            base = mrays
        rows.append({
            "devices": n,
            "ms": round(dt * 1e3, 3),
            "ms_quarter_batch": round(dtq * 1e3, 3),
            "work_ms": round(work * 1e3, 3),
            "overhead_ms": round(overhead * 1e3, 3),
            "mrays_per_s": round(mrays, 3),
            "efficiency": round(mrays / (base * n), 4),
        })
    return rows
