"""Benchmark sweep harness: BVH vs brute force over scene sizes.

The re-expression of ``run_benchmark_with_plotting`` (src/benchmark.c:
283-332): sweep sphere counts, generate the reference's random scenes
(r=0.5 in a world_size^3 box), time closest-hit for a batch of origin rays
with and without the BVH, and fit complexity curves the way
``results/main.py`` does (linear fit for brute force, log fit + log-log
slopes for BVH). The data file keeps the reference's gnuplot format
("n time_brute time_bvh", ``results/benchmark_data.txt``); plotting is left
to gnuplot as in the reference (src/benchmark.c:34-136).

Timing via tracer.bench.timing.time_calls (median over calls after warm-up;
compilation excluded).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from tracer.core.types import Ray


@dataclasses.dataclass
class SweepResult:
    sizes: list
    brute_s: list          # seconds per batch (NaN where skipped);
                           # extrapolated from brute_nb timed rays
    bvh_s: list            # seconds per batch, END TO END (prep included)
    build_ms: list
    num_rays: int
    path: str              # which traversal implementation was measured
    brute_nb: list = dataclasses.field(default_factory=list)
    row_paths: list = dataclasses.field(default_factory=list)  # per size

    def speedups(self):
        return [b / v if (b == b and v == v and v > 0) else float("nan")
                for b, v in zip(self.brute_s, self.bvh_s)]

    def mrays_bvh(self):
        return [self.num_rays / v / 1e6 if v == v and v > 0 else float("nan")
                for v in self.bvh_s]

    def to_json(self) -> dict:
        return {
            "sizes": list(map(int, self.sizes)),
            "brute_s": self.brute_s,
            "bvh_s": self.bvh_s,
            "build_ms": self.build_ms,
            "num_rays": self.num_rays,
            "brute_nb_timed": list(map(int, self.brute_nb)),
            "brute_note": "brute times at large n are linear extrapolations "
                          "from brute_nb_timed rays (work product capped)",
            "speedup": self.speedups(),
            "mrays_bvh": self.mrays_bvh(),
            "path": self.path,
            "row_paths": self.row_paths,
            "complexity": complexity_fit(self.sizes, self.brute_s, self.bvh_s),
        }

    def save_data_txt(self, path: str) -> None:
        """results/benchmark_data.txt-compatible: 'n brute_s bvh_s' rows."""
        with open(path, "w") as f:
            for n, b, v in zip(self.sizes, self.brute_s, self.bvh_s):
                f.write(f"{n} {b:.6f} {v:.6f}\n")


def complexity_fit(sizes, brute_s, bvh_s) -> dict:
    """The fits of results/main.py:20-87: brute ~ O(n) (linear fit +
    log-log slope ~ 1), BVH ~ O(log n) (log fit + log-log slope << 1)."""
    n = np.asarray(sizes, np.float64)
    out = {}
    bb = np.asarray(brute_s, np.float64)
    vv = np.asarray(bvh_s, np.float64)
    ok = np.isfinite(bb)
    if ok.sum() >= 2:
        slope = np.polyfit(np.log(n[ok]), np.log(bb[ok]), 1)[0]
        out["brute_loglog_slope"] = float(slope)
    ok = np.isfinite(vv) & (vv > 0)
    if ok.sum() >= 2:
        slope = np.polyfit(np.log(n[ok]), np.log(vv[ok]), 1)[0]
        out["bvh_loglog_slope"] = float(slope)
        # log fit: t = b*log(n) + a (results/main.py:24-26)
        coef = np.polyfit(np.log(n[ok]), vv[ok], 1)
        out["bvh_logfit"] = [float(coef[0]), float(coef[1])]
    return out


def run_sweep(sizes=(5000, 10000, 15000, 20000, 25000, 30000,
                     35000, 40000, 45000, 50000),
              num_rays: int = 131072, world_size: float = 1000.0,
              brute_limit: int = 20_000_000, seed: int = 0,
              dense_limit: int | None = None,
              log: Callable = print) -> SweepResult:
    """Run the sweep. Default sizes = the reference's in-repo sweep
    (src/benchmark.c:289-295); pass (1000, 10000, ..., 1e6+) for the
    published-data variant (src/benchmark.c:296).

    Brute force is timed with an adaptively smaller ray batch at large n
    (the O(n*rays) product is capped; the reference used a fixed 10k rays,
    src/benchmark.c:289) and normalized to seconds per ``num_rays`` rays.
    The BVH side runs whatever tracer/intersect/select.py picks for each
    size (recorded per row), end to end: ray prep + cull + phase B.
    """
    import jax
    import jax.numpy as jnp
    from tracer.bench.timing import time_calls
    from tracer.bench.workload import closest_oneshot
    from tracer.intersect import select
    from tracer.intersect.brute import brute_t_fast, nearest_hit_brute
    from tracer.intersect.sphere import ray_sphere_t
    from tracer.scene.scene import benchmark_scene

    if dense_limit is None:
        dense_limit = select.DENSE_LIMIT
    CHUNK = 65536

    def brute_t(rays: Ray, scene) -> jnp.ndarray:
        """Min-t brute force, lax.scan-chunked over spheres so the (B, N)
        pair matrix never materializes."""
        n = scene.centers.shape[0]
        if n <= CHUNK:
            return nearest_hit_brute(rays, scene).t
        pad = (-n) % CHUNK
        c = jnp.concatenate(
            [scene.centers, jnp.full((pad, 3), 3.0e37, jnp.float32)])
        r = jnp.concatenate([scene.radii, jnp.zeros((pad,), jnp.float32)])
        o = rays.origin.reshape(-1, 3)
        d = rays.direction.reshape(-1, 3)

        def body(best, xs):
            cc, rr = xs
            t = ray_sphere_t(o[:, None], d[:, None], cc[None], rr[None])
            return jnp.minimum(best, jnp.min(t, axis=1)), None

        init = jnp.full((o.shape[0],), jnp.inf, jnp.float32)
        best, _ = jax.lax.scan(body, init,
                               (c.reshape(-1, CHUNK, 3),
                                r.reshape(-1, CHUNK)))
        return best

    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Ray(origin=jnp.zeros((num_rays, 3), jnp.float32),
               direction=jnp.asarray(d))

    res = SweepResult(sizes=list(sizes), brute_s=[], bvh_s=[], build_ms=[],
                      num_rays=num_rays,
                      path="leafcull_" + select.hierarchical_impl(),
                      brute_nb=[])

    brute_fn = jax.jit(brute_t)
    for n in sizes:
        scene = benchmark_scene(jax.random.PRNGKey(seed + n), int(n),
                                world_size=world_size)
        path = select.choose_path(int(n), dense_limit=dense_limit)

        if n <= brute_limit:
            # Cap the materialized (rays, sphere-chunk) pair block at 2^28
            # elements (~1 GB of f32 temporaries); nb (the ray count
            # actually timed) is recorded per point and the scaled result
            # marked as an extrapolation.
            nb = num_rays
            while nb > 2048 and nb * min(n, CHUNK) > (1 << 28):
                nb //= 2
            rb = Ray(origin=rays.origin[:nb], direction=rays.direction[:nb])
            tb, _ = time_calls(brute_fn, rb, scene, n=3, warmup=1)
            res.brute_s.append(tb.median_s * (num_rays / nb))
            res.brute_nb.append(nb)
        else:
            res.brute_s.append(float("nan"))
            res.brute_nb.append(0)

        if path == "dense":
            fn = jax.jit(brute_t_fast)
            tv, _ = time_calls(fn, rays.origin, rays.direction,
                               scene.centers, scene.radii, n=3, warmup=1)
            res.build_ms.append(0.0)
            res.row_paths.append(path)
        else:
            isect = select.make_intersector(scene, path)
            res.build_ms.append(isect.info["bvh_build_ms"])
            # Tables are arguments, not closure constants: closed-over
            # arrays would be baked into the compiled program.
            fn2 = jax.jit(closest_oneshot(path[len("leafcull_"):]))
            tv, _ = time_calls(fn2, rays.origin, rays.direction,
                               isect.tables, n=3, warmup=1)
            res.row_paths.append(
                path + ("_lbvh" if isect.info["bvh_build"] == "device_lbvh"
                        else ""))
        res.bvh_s.append(tv.median_s)
        log(f"n={n}: {res.row_paths[-1]}, build {res.build_ms[-1]:.0f} ms, "
            f"brute {res.brute_s[-1]:.4f} s, bvh {res.bvh_s[-1]:.4f} s "
            f"({res.mrays_bvh()[-1]:.1f} Mrays/s)")

    return res
