"""Benchmark: closest-hit ray throughput at the reference's scale on one GPU.

The headline metric of BASELINE.md: closest-hit throughput with the SAH BVH
at 100k spheres on the reference's benchmark distribution (spheres r=0.5
uniform in a 1000^3 world, 512 * 1024 rays from the origin;
src/benchmark.c:172-223, 283-332), end to end in one jit: ray prep
(octahedral sort + cell bucketing) + phase A (hierarchical cull) + phase B
(the intersector the selector picks), results in input ray order. Stage
times, the plain-XLA phase B, shadow rays, the device LBVH build and the
sparse differentiable path are reported beside it.

    python bench.py

Prints exactly one JSON line on stdout. Exits non-zero, printing no result,
when JAX's platform is not ``gpu``.
"""

import json
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracer.bench import workload as W
    from tracer.bench.timing import time_calls
    from tracer.compile_cache import enable_compile_cache
    from tracer.intersect.select import build_bvh_for, make_intersector
    from tracer.kernels.leafcull import (bounds_from_feats, build_cull_tables,
                                         candidate_rows, phase_b,
                                         prep_feats_bucketed)
    from tracer.scene.scene import benchmark_scene

    dev = W.device_info()
    if dev["platform"] != "gpu":
        log(f"bench.py measures the GPU; JAX's platform is {dev['platform']}")
        return 1
    enable_compile_cache()
    out = {"metric": "bvh_closest_hit_throughput_100k_spheres_e2e",
           "unit": "Mrays/s", "device": dev, "card": W.gpu_card()}

    scene = benchmark_scene(jax.random.PRNGKey(1), W.N_SPHERES,
                            world_size=W.WORLD)
    isect = make_intersector(scene)
    tables = isect.tables
    out.update(isect.info)
    impl = isect.path[len("leafcull_"):]
    o, d = W.origin_rays(W.NUM_RAYS)
    B = W.NUM_RAYS

    def run(name, fn, *args, n=10):
        timing, res = time_calls(jax.jit(fn), *args, n=n)
        out[name] = timing.to_json()
        log(f"{name}: {timing.median_ms:.3f} ms (min {timing.min_s * 1e3:.3f}"
            f", max {timing.max_s * 1e3:.3f}; first call "
            f"{timing.first_call_s:.1f} s)")
        return timing, res

    tk, (t, _, _) = run("closest_ms", W.closest_oneshot(impl), o, d, tables)
    value = B / tk.median_s / 1e6
    out["hit_fraction"] = float(np.isfinite(np.asarray(t)).mean())
    tx, _ = run("closest_xla_ms", W.closest_oneshot("xla"), o, d, tables)
    out["closest_xla_mrays"] = B / tx.median_s / 1e6

    # Stage split (standalone stages with materialized operands; reported,
    # not subtracted from the headline).
    _, (feats, _) = run("prep_ms", lambda o, d: prep_feats_bucketed(
        o, d, W.SUBPACKET, cell_bits=W.CELL_BITS), o, d)
    _, (rows, _) = run("phase_a_ms", lambda f, tb: candidate_rows(
        bounds_from_feats(f), tb), feats, tables)
    run("phase_b_ms", lambda f, r, tb: phase_b(f, r, tb, impl), feats, rows,
        tables)
    run("phase_b_xla_ms", lambda f, r, tb: phase_b(f, r, tb, "xla"), feats,
        rows, tables)

    ts, (occ, _) = run("shadow_ms", W.shadow_oneshot(impl, 500.0), o, d,
                       tables)
    out["shadow_mrays"] = B / ts.median_s / 1e6
    out["shadow_occluded_fraction"] = float(np.asarray(occ).mean())
    tsx, _ = run("shadow_xla_ms", W.shadow_oneshot("xla", 500.0), o, d,
                 tables)
    out["shadow_xla_mrays"] = B / tsx.median_s / 1e6

    # On-device LBVH at the headline size, and the same query on its tree.
    dbvh, dinfo = build_bvh_for(scene, device_build_min_n=0)
    out["bvh_build_device_ms"] = dinfo["bvh_build_ms"]
    tl, _ = run("closest_lbvh_ms", W.closest_oneshot(impl), o, d,
                build_cull_tables(scene, dbvh))
    out["lbvh_mrays"] = B / tl.median_s / 1e6

    # Sparse differentiable forward + backward on a fit-scale microbatch
    # (tracer/diff/sparse.py), BASELINE's differentiable metric.
    from tracer.core.sort import prep_rays_bucketed
    from tracer.core.types import Ray
    from tracer.diff.soft import SoftParams
    from tracer.diff.sparse import soft_render_sparse_leaforder

    Bd = 131072
    padded, _ = jax.jit(lambda o, d: prep_rays_bucketed(
        Ray(origin=o, direction=d), 64))(o[:Bd], d[:Bd])
    sp = SoftParams()

    def loss(centers, tb):
        img, _ = soft_render_sparse_leaforder(
            scene.replace(centers=centers), padded.origin, padded.direction,
            tb, sp, max_leaves=16, subpacket=64)
        return jnp.mean(img)

    tg, _ = run("diff_fwd_bwd_ms", jax.grad(loss), scene.centers, tables,
                n=5)
    out["diff_fwd_bwd_mrays"] = Bd / tg.median_s / 1e6

    out["value"] = value
    out["vs_baseline"] = value / W.BASELINE_MRAYS
    out["peak_bytes_in_use"] = jax.devices()[0].memory_stats().get(
        "peak_bytes_in_use")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
