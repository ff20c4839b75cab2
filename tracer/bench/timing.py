"""Wall-clock timing of jitted device work.

One timer for every measurement in the repo: the host clock read around
``jax.block_until_ready``, after warm-up calls that compile and settle the
allocator, reported as the median and spread (min, max) over ``n`` calls.
The first call's time (compilation included) is kept separately so callers
can report compile seconds as set-up.
"""

from __future__ import annotations

import dataclasses
import statistics
import time


@dataclasses.dataclass(frozen=True)
class Timing:
    median_s: float
    min_s: float
    max_s: float
    n: int
    first_call_s: float       # first warm-up call, compilation included

    @property
    def median_ms(self) -> float:
        return self.median_s * 1e3

    def to_json(self) -> dict:
        return {"median_ms": self.median_s * 1e3, "min_ms": self.min_s * 1e3,
                "max_ms": self.max_s * 1e3, "n": self.n,
                "first_call_s": self.first_call_s}


def time_calls(fn, *args, n: int = 10, warmup: int = 2):
    """Time ``fn(*args)`` over ``n`` calls after ``warmup`` untimed ones:
    returns ``(Timing, last output)``. With ``warmup=0`` the first timed
    call includes compilation."""
    import jax

    samples = []
    for _ in range(warmup + n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    timed = samples[warmup:]
    return Timing(median_s=statistics.median(timed), min_s=min(timed),
                  max_s=max(timed), n=n, first_call_s=samples[0]), out
