"""Query-path perf sweep on the accelerator.

Builds (or loads) a synthetic index and sweeps query batch size, beam
expansion factor, and compressed mode, reporting QPS and recall for each
point.  Used to pick the serving defaults baked into bench.py.

Usage: python tools/perf_query.py [--n 56000] [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=56000)
    p.add_argument("--m", type=int, default=400)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--ef", type=int, default=40)
    p.add_argument("--quick", action="store_true")
    args = p.parse_args()
    if args.quick:
        args.n = 8000

    from expann_tpu.data.loader import load_synthetic_uniform_sphere_points
    from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
    from expann_tpu.utils.persist import index_exists, load_index, save_index

    ds = load_synthetic_uniform_sphere_points(args.n, args.m, args.k, args.d)
    idx_path = f"data/perf_idx_n{args.n}.npz"
    cfg = AntitopoConfig(
        M=60, ef_construction=500, precision="default",
        index_filename=idx_path, read_index=True, write_index=True,
    )
    eng = AntitopoEngine(config=cfg)
    eng.store_many_vectors(ds.vecs)
    t0 = time.perf_counter()
    eng.build()
    print(f"build/load: {time.perf_counter() - t0:.1f}s", flush=True)

    gt_sets = [set(int(v) for v in row) for row in ds.ground_truth]

    def run(B, expand, compressed, ef):
        eng.cfg.query_block = B
        eng.cfg.query_expand = expand
        eng.cfg.use_compression = compressed
        if compressed and eng.graph.codes is None:
            import dataclasses

            from expann_tpu.ops.quantize import quantize_simple

            codes, cn = quantize_simple(eng.graph.vectors)
            eng.graph = dataclasses.replace(eng.graph, codes=codes, code_norms=cn)
        eng.set_ef_search(ef)
        ans = eng.query_k_batch(ds.queries, args.k)
        hits = sum(
            len(set(int(v) for v in ans[q]) & gt_sets[q]) for q in range(args.m)
        )
        recall = hits / (args.m * args.k)
        Q = max(4 * B, 4096)
        reps = int(np.ceil(Q / args.m))
        big = np.tile(ds.queries, (reps, 1))[:Q]
        eng.query_k_batch(big, args.k)  # warmup
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            eng.query_k_batch(big, args.k)
            best = min(best, time.perf_counter() - t0)
        qps = Q / best
        ncomp = eng.num_distcomps_compressed if compressed else eng.num_distcomps
        print(
            f"B={B:5d} expand={expand} comp={int(compressed)} ef={ef}: "
            f"recall={recall:.4f} qps={qps:9.0f} ({1e6 / qps:7.1f} us/q)",
            flush=True,
        )

    for B in [1024, 4096]:
        for expand in [1, 2, 4]:
            run(B, expand, False, args.ef)
    for B in [4096]:
        for expand in [1, 4]:
            run(B, expand, True, args.ef)


if __name__ == "__main__":
    main()
