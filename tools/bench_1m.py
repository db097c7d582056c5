"""Million-row single-device benchmark (the SIFT1M-shaped slot).

Synthetic 1M x d=128 corpus (SIFT fvecs files are absent in-image — the
loaders in data/loader.py run the real thing unchanged when they exist).
Measures:
  * index build wall-clock (distributed one-shot builder on a 1-device
    mesh with flat_topk candidates — the million-row path),
  * graph query pareto: recall@10 vs QPS (the XLA gather beam),
  * flat-scan points (bf16 and int8 flat_topk) for comparison.

Ground truth: exact XLA matmul top-k (BruteForceEngine mode='exact').

Usage: python tools/bench_1m.py [--n 1000000] [--data sift-like] [--skip-build]
Writes results as JSON lines; the built index and ground truth are cached
under index/ for query-side re-runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "index"
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=400)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--skip-build", action="store_true")
    # build + save the index npz, then exit (no GT, no serving sweeps)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--M", type=int, default=48)
    ap.add_argument("--efc", type=int, default=300)
    # "gaussian" = the reference's isotropic synthetic (hard at 1M —
    # curse of dimensionality); "clustered" = mixture of 1000 Gaussians
    # modelling real-corpus intrinsic dimension; "sift-like" = the
    # clustered corpus in SIFT's u8-valued box (data/loader.py)
    # "fvecs:<dir>" loads a real corpus from <dir>/{sift_base.fvecs,
    # sift_query.fvecs, sift_groundtruth.ivecs} (the reference's SIFT1M
    # layout, src/main.cpp:72-80) — any real fvecs corpus drops in with
    # no code change the day the files exist in-image
    ap.add_argument("--data", default="gaussian")
    # serve an explicit index file instead of the derived cache path
    ap.add_argument("--idx", default="")
    ap.add_argument("--qb", type=int, default=8192, help="serving query_block")
    ap.add_argument("--expand", type=int, default=1, help="query_expand")
    ap.add_argument("--ef-list", default="40,80,128,200,256")
    ap.add_argument("--skip-flat", action="store_true")
    args = ap.parse_args()
    if not (args.data in ("gaussian", "clustered", "sift-like")
            or args.data.startswith("fvecs:")):
        ap.error("--data must be gaussian, clustered, sift-like or fvecs:<dir>")
    # n tag keeps non-1M runs (e.g. the 2M crossover demo) from
    # colliding with the canonical 1M cache files
    ntag = "" if args.n == 1_000_000 else f"_n{args.n}"
    dtag = ("fvecs_" + os.path.basename(args.data[6:].rstrip("/"))
            if args.data.startswith("fvecs:") else args.data)
    os.makedirs(CACHE, exist_ok=True)
    IDX = args.idx or os.path.join(CACHE, f"bench_1m_idx_M{args.M}_{dtag}{ntag}.npz")
    GT = os.path.join(CACHE, f"bench_1m_gt_{dtag}{ntag}.npz")

    from expann_tpu.data.loader import (
        generate_sift_like,
        generate_synthetic,
        generate_synthetic_clustered,
    )
    from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
    from expann_tpu.models.brute_force import BruteForceEngine
    from expann_tpu.models.build import BuildConfig
    from expann_tpu.parallel.distbuild import build_distributed
    from expann_tpu.parallel.sharded import make_mesh
    from expann_tpu.utils.persist import save_index

    n, m, d, k = args.n, args.m, args.d, args.k
    gt = "unset"
    if args.data.startswith("fvecs:"):
        from expann_tpu.data.loader import load_sift1m

        base = args.data[6:].rstrip("/")
        print(f"loading fvecs corpus from {base}/ ...", flush=True)
        ds = load_sift1m(
            os.path.join(base, "sift_base.fvecs"),
            os.path.join(base, "sift_query.fvecs"),
            os.path.join(base, "sift_groundtruth.ivecs"),
            k_custom=k,
        )
        x = np.asarray(ds.vecs, np.float32)
        queries = np.asarray(ds.queries, np.float32)
        gt = np.asarray(ds.ground_truth)
        n, d = x.shape
        m, k = gt.shape
        print(f"fvecs corpus: n={n} d={d} m={m} k={k}", flush=True)
    else:
        print(f"generating synthetic n={n} d={d} ...", flush=True)
        if args.data == "clustered":
            x, queries = generate_synthetic_clustered(n, m, d, seed=0)
        elif args.data == "sift-like":
            x, queries = generate_sift_like(n, m, d, seed=7)
        else:
            x, queries = generate_synthetic(n, m, d, seed=0)

    # ---- exact ground truth ----
    if not isinstance(gt, str):
        pass  # fvecs ground truth came with the files
    elif args.build_only:
        gt = None
    elif os.path.exists(GT):
        gt = np.load(GT)["gt"]
    else:
        t0 = time.perf_counter()
        bf = BruteForceEngine(batch_size=100)
        bf.store_many_vectors(x)
        bf.build()
        gt = bf.query_k_batch(queries, k)
        print(f"exact GT: {time.perf_counter() - t0:.0f}s", flush=True)
        np.savez(GT, gt=gt)
        del bf

    gt_sets = None if gt is None else [set(int(v) for v in row) for row in gt]

    def recall(ids):
        return float(
            np.mean([len(set(int(v) for v in a[:k]) & g) / k
                     for a, g in zip(ids, gt_sets)])
        )

    results = []

    # ---- build: distributed one-shot on a 1-device mesh ----
    cfg = BuildConfig(M=args.M, ef_construction=args.efc, prune_cand=args.efc)
    built = not (args.skip_build and os.path.exists(IDX))
    if not built:
        build_s = None
    else:
        mesh = make_mesh(1)
        t0 = time.perf_counter()
        graph, stats = build_distributed(
            x, cfg, mesh, wave_size=4096, mode="oneshot",
            candidates="flat", verbose=True,
        )
        build_s = time.perf_counter() - t0
        print(f"build: {build_s:.0f}s  {stats}", flush=True)
        save_index(IDX, graph, {"dim": d})
        del graph
        if not args.build_only:
            results.append({"point": "build", "build_s": round(build_s, 1),
                            "n": n, **stats})

    if args.build_only:
        if built:
            print(f"build-only: index saved to {IDX}", flush=True)
        else:
            print(f"build-only: index already present at {IDX} "
                  "(build skipped)", flush=True)
        return

    # ---- graph query pareto (XLA gather beam) ----
    rng = np.random.default_rng(99)
    for ef in (int(v) for v in args.ef_list.split(",")):
        acfg = AntitopoConfig(
            M=args.M, ef_construction=args.efc, ef_search=ef,
            query_expand=args.expand, query_block=args.qb,
            index_filename=IDX, read_index=True,
        )
        eng = AntitopoEngine(config=acfg)
        eng.build()
        rec = recall(eng.query_k_batch(queries, k))
        dc = (eng.num_distcomps + eng.num_distcomps_compressed) / m
        B = 16384
        eng.query_k_batch(rng.standard_normal((B, d)).astype(np.float32), k)
        best = 1e9
        for _ in range(3):
            qs = rng.standard_normal((B, d)).astype(np.float32)
            t0 = time.perf_counter()
            eng.query_k_batch(qs, k)
            best = min(best, time.perf_counter() - t0)
        pt = {"point": f"antitopo_ef{ef}_e{args.expand}_qb{args.qb}",
              "recall": round(rec, 4), "qps": round(B / best, 1),
              "distcomps": round(dc, 1)}
        results.append(pt)
        print(json.dumps(pt), flush=True)
        del eng

    # ---- flat scans ----
    for mode in () if args.skip_flat else ("fused", "fused_i8"):
        eng = BruteForceEngine(mode=mode)
        eng.store_many_vectors(x)
        t0 = time.perf_counter()
        eng.build()
        fb = time.perf_counter() - t0
        rec = recall(eng.query_k_batch(queries, k))
        B = 16384
        eng.query_k_batch(rng.standard_normal((B, d)).astype(np.float32), k)
        best = 1e9
        for _ in range(3):
            qs = rng.standard_normal((B, d)).astype(np.float32)
            t0 = time.perf_counter()
            eng.query_k_batch(qs, k)
            best = min(best, time.perf_counter() - t0)
        pt = {"point": f"flat_{mode}", "recall": round(rec, 4),
              "qps": round(B / best, 1), "build_s": round(fb, 1)}
        results.append(pt)
        print(json.dumps(pt), flush=True)
        del eng

    print(json.dumps({"summary_1m": results}), flush=True)


if __name__ == "__main__":
    main()
