"""Benchmark: recall@10 vs QPS on the canonical synthetic config
(n=56000, m=400, d=128, k=10 — the reference's config_synthetic.json).

Measures the engine suite and reports the best QPS among points with
recall@10 >= 0.95:
  * the flat engine — the flat_topk kernel (ops/pallas_topk.py) over a
    bf16 corpus, and over int8 codes with an f32 rerank,
  * the Anti-Topo graph engine at a few ef_search points (the XLA gather
    beam, models/search.py).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

vs_baseline: the reference publishes no numbers (BASELINE.md) and cannot be
built in this image (empty Eigen/pybind11 submodules, no network).  The
denominator is a single-core C++ re-implementation of the reference's
serving loop (greedy descent + bottom-layer beam search + autovectorized
AVX-512 L2, reference src/antitopo_engine.h:497-688,854-903) over the same
built 56k graph: 587.2 QPS at recall@10 = 0.952 (ef=100) on a 1-core
2.1GHz Xeon — native/baseline_search.cpp, methodology in BASELINE.md.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_QPS_MEASURED = 587.2  # native/baseline_search.cpp @ recall 0.952
BASELINE_BUILD_S = 1028.9  # native/baseline_build.cpp, 56k M=60 efc=500 solo
RECALL_TARGET = 0.95


def _recall(ans, gt_sets, k):
    m = len(gt_sets)
    hits = sum(
        len(set(int(v) for v in ans[i]) & gt_sets[i]) for i in range(m)
    )
    return hits / (m * k)


def _qps(eng, d, k, Q=8192, seed=20260816, reps=5):
    """Throughput on UNIQUE random queries, a fresh batch per repetition.

    Tiling the 400 real queries would give a graph traversal
    unrepresentatively identical beams; unique N(0,1) queries match the
    synthetic dataset's query distribution
    (data/loader.py:generate_synthetic).

    Returns ``(median_qps, best_qps)`` over ``reps`` timed runs: the
    MEDIAN is the reported number, the best is recorded alongside."""
    rng = np.random.default_rng(seed)

    def batch():
        return rng.standard_normal((Q, d)).astype(np.float32)

    eng.query_k_batch(batch(), k)  # warmup / compile
    times = []
    for _ in range(reps):
        b = batch()
        t0 = time.perf_counter()
        eng.query_k_batch(b, k)
        times.append(time.perf_counter() - t0)
    return Q / float(np.median(times)), Q / min(times)


def _device_qps_flat(flat, k, Q=65536, reps=5):
    """Device-side flat-scan rate: queries generated ON DEVICE (fresh
    PRNG key per rep), one flat_topk dispatch per timed rep.  Excludes the
    host->device query transfer."""
    import jax
    import jax.numpy as jnp

    from expann_tpu.ops.pallas_topk import flat_topk

    corpus = flat._flat
    D = corpus.x.shape[1]

    @jax.jit
    def gen(key):
        return jax.random.normal(key, (Q, D), jnp.float32)

    def run(key):
        ids, _ = flat_topk(gen(key), corpus.x, corpus.norms, k=k)
        return ids

    run(jax.random.PRNGKey(0)).block_until_ready()  # warmup/compile
    times = []
    for r in range(reps):
        q_key = jax.random.PRNGKey(r + 1)
        t0 = time.perf_counter()
        run(q_key).block_until_ready()
        times.append(time.perf_counter() - t0)
    return Q / float(np.median(times))


def main() -> None:
    quick = os.environ.get("BENCH_QUICK") == "1"
    n, m, d, k = (8000, 200, 128, 10) if quick else (56000, 400, 128, 10)

    from expann_tpu.data.loader import load_synthetic_uniform_sphere_points
    from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
    from expann_tpu.models.brute_force import BruteForceEngine

    ds = load_synthetic_uniform_sphere_points(n=n, m=m, k=k, d=d)
    gt_sets = [set(int(v) for v in row) for row in ds.ground_truth]
    points = []  # (name, recall, qps, distcomps, best qps)

    # --- flat engine: flat_topk kernel over a bf16 corpus ---
    flat = BruteForceEngine(mode="fused")
    flat.store_many_vectors(ds.vecs)
    t0 = time.perf_counter()
    flat.build()
    flat_build_s = time.perf_counter() - t0
    flat_recall = _recall(flat.query_k_batch(ds.queries, k), gt_sets, k)
    flat_qps, flat_best = _qps(flat, d, k, Q=16384 if quick else 65536)
    # a flat scan scores the whole corpus once per query
    points.append(("flat_bf16", flat_recall, flat_qps, n, flat_best))
    flat_dev_qps = _device_qps_flat(flat, k, Q=16384 if quick else 65536)

    # --- flat engine over int8 codes + f32 rerank, i8 query wire ---
    if not quick:
        flat8 = BruteForceEngine(mode="fused_i8", query_wire="i8")
        flat8.store_many_vectors(ds.vecs)
        flat8.build()
        rec8 = _recall(flat8.query_k_batch(ds.queries, k), gt_sets, k)
        qps8, best8 = _qps(flat8, d, k, Q=65536)
        points.append(("flat_i8", rec8, qps8, n, best8))

    # --- Anti-Topo graph engine ---
    # prune_overflow=1 and full-width prune candidates sit inside the
    # reference's own sweep grid (src/bench_runner.h:133-163).
    cfg = AntitopoConfig(
        M=60,
        ef_construction=500,
        ortho_count=1,
        prune_overflow=1,
        prune_cand=500,
        query_expand=2,
        query_block=16384,
        precision="default",
    )
    graph = AntitopoEngine(config=cfg)
    graph.store_many_vectors(ds.vecs)
    t0 = time.perf_counter()
    graph.build()
    graph_build_s = time.perf_counter() - t0
    for mult in ([4] if quick else [4, 6, 10, 12]):
        graph.set_ef_search(k * mult)  # also resets distcomp counters
        rec = _recall(graph.query_k_batch(ds.queries, k), gt_sets, k)
        distcomps = (
            graph.num_distcomps + graph.num_distcomps_compressed
        ) / m  # per query, from the recall run (RECORD_STATS parity)
        qps, qbest = _qps(graph, d, k, Q=8192 if quick else 65536)
        points.append((f"antitopo_ef{k * mult}", rec, qps, distcomps, qbest))

    qualifying = [p for p in points if p[1] >= RECALL_TARGET]
    best = max(qualifying, key=lambda p: p[2]) if qualifying else max(
        points, key=lambda p: p[1]
    )

    import jax

    dev = jax.devices()[0]
    out = {
        "metric": f"synthetic n={n} d=128 best QPS at recall@10>={RECALL_TARGET}",
        "value": round(best[2], 1),
        "unit": "qps",
        "vs_baseline": round(best[2] / BASELINE_QPS_MEASURED, 3),
        "best_engine": best[0],
        "recall": round(best[1], 4),
        "time_per_query_ns": round(1e9 / best[2], 0),
        "qps_stat": "median of 5 (fresh unique batches); qps_best alongside",
        "flat_device_qps": round(flat_dev_qps, 1),
        "pareto": [
            {
                "engine": nm,
                "recall": round(r, 4),
                "qps": round(q, 1),
                "qps_best": round(qb, 1),
                "distcomps_per_query": round(dc, 1),
            }
            for nm, r, q, dc, qb in points
        ],
        "flat_build_s": round(flat_build_s, 1),
        "graph_build_s": round(graph_build_s, 1),
        "vs_baseline_build": round(BASELINE_BUILD_S / graph_build_s, 2),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "baseline_note": (
            "vs_baseline = single-core CPU reference-loop QPS "
            "(587.2 @ recall 0.952, native/baseline_search.cpp, "
            "BASELINE.md); vs_baseline_build = single-core insert-loop "
            "build wall-clock (1028.9s at the canonical 56k config, "
            "native/baseline_build.cpp) / graph_build_s"
        ),
        "pairing_note": (
            "recall is measured on the 400 canonical queries; QPS on "
            "fresh unique N(0,1) batches of the same distribution"
        ),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
