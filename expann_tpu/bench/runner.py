"""Parameter-sweep job runner.

Counterpart of the reference's bench_runner (reference:
src/bench_runner.h:124-180): builds the canonical job grid over engine
params and runs each job, collecting results into a BenchDataManager.  The
reference's std::jthread pool with atomic job claiming (:15-58,77-87) was
host-side CPU parallelism over *independent single-threaded engines*; on a
single accelerator the device is the bottleneck and is time-shared, so
jobs run sequentially (num_threads is accepted for CLI parity).  Builds are
reused across jobs that share all build-affecting params, mirroring the
reference's index-file read/write scheme (:149-158).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from expann_tpu.bench.bench_data import BenchData
from expann_tpu.bench.harness import get_benchmark_data
from expann_tpu.bench.manager import BenchDataManager
from expann_tpu.data.dataset import TestDataset
from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu.ops.quantize import quantize_simple


def canonical_job_grid(index_dir: str = "index") -> List[AntitopoConfig]:
    """The reference's sweep (src/bench_runner.h:133-163): M=60, M0=2M,
    ef_search_mult in 1..6, ef_construction = M * (500 / M),
    ortho_count=1, ortho_factor=0.5, ortho_bias=0.0,
    prune_overflow in {0, 1}, use_compression in {false, true}."""
    jobs = []
    for k in [60]:
        for num_for_1nn in [1, 2, 3, 4, 5, 6]:
            for edge_count_search_factor in [500 // k]:
                for use_compression in [False, True]:
                    for prune_overflow in [0, 1]:
                        filename = (
                            f"{index_dir}/sift_k{k}"
                            f"_efx{edge_count_search_factor}"
                            f"_orthocount1_orthofactor0.500000"
                            f"_orthobias0.000000"
                            f"_pruneoverflow{prune_overflow}"
                        )
                        jobs.append(
                            AntitopoConfig(
                                M=k,
                                M0=2 * k,
                                ef_search_mult=num_for_1nn,
                                ef_construction=k * edge_count_search_factor,
                                ortho_count=1,
                                ortho_factor=0.5,
                                ortho_bias=0.0,
                                prune_overflow=prune_overflow,
                                use_compression=use_compression,
                                index_filename=filename,
                                read_index=True,
                                write_index=True,
                            )
                        )
    return jobs


def _build_key(c: AntitopoConfig) -> Tuple:
    return (
        c.M,
        c.M0,
        c.ef_construction,
        c.ortho_count,
        c.ortho_factor,
        c.ortho_bias,
        c.prune_overflow,
        c.seed,
        c.prune_cand,
    )


def _score(eng, ds, ans, per_query_ns, build_ns) -> BenchData:
    m, k = ds.m, ds.k
    gt = ds.ground_truth
    num_best_found = 0
    avg_d = 0.0
    avg_d2 = 0.0
    for q in range(m):
        valid = [int(v) for v in ans[q] if 0 <= v < ds.n]
        num_best_found += len(set(valid).intersection(int(v) for v in gt[q]))
        if valid:
            top1 = valid[0]
            diff = ds.queries[q].astype(np.float64) - ds.vecs[top1].astype(
                np.float64
            )
            d2 = float(np.dot(diff, diff))
            avg_d += np.sqrt(d2)
            avg_d2 += d2
    return BenchData(
        time_per_query_ns=per_query_ns,
        time_to_build_ns=build_ns,
        average_distance=avg_d / m,
        average_squared_distance=avg_d2 / m,
        recall=num_best_found / (m * k),
        engine_name=eng.name(),
        param_list=eng.param_list(),
    )


def perform_benchmarks(
    ds: TestDataset,
    num_threads: int = 1,
    jobs: Optional[List[AntitopoConfig]] = None,
    verbose: bool = True,
) -> BenchDataManager:
    del num_threads  # device-bound; kept for CLI parity
    if jobs is None:
        jobs = canonical_job_grid()
    bdm = BenchDataManager(ds.name)

    built: Dict[Tuple, Tuple[AntitopoEngine, float]] = {}
    total = len(jobs)
    for i, conf in enumerate(jobs):
        key = _build_key(conf)
        if verbose:
            print(
                f"Running job {i + 1}/{total}: ef_search_mult="
                f"{conf.ef_search_mult} use_compression={conf.use_compression} "
                f"prune_overflow={conf.prune_overflow}"
            )
        try:
            if key in built:
                base_eng, build_ns = built[key]
                eng = AntitopoEngine(config=conf)
                eng.graph = base_eng.graph
                eng.n = base_eng.n
                eng.dim = base_eng.dim
                if conf.use_compression and eng.graph.codes is None:
                    codes, code_norms = quantize_simple(eng.graph.vectors)
                    eng.graph = dataclasses.replace(
                        eng.graph, codes=codes, code_norms=code_norms
                    )
                    built[key] = (eng, build_ns)
                eng.query_k_batch(ds.queries, ds.k)  # untimed compile warmup
                eng.reset_stats()
                t0 = time.perf_counter_ns()
                ans = eng.query_k_batch(ds.queries, ds.k)
                t1 = time.perf_counter_ns()
                bd = _score(eng, ds, ans, (t1 - t0) / ds.m, build_ns)
            else:
                eng = AntitopoEngine(config=conf)
                bd = get_benchmark_data(eng, ds)
                built[key] = (eng, bd.time_to_build_ns)
            bdm.add(bd)
            if verbose:
                print(f"Completed job {i + 1}/{total}: {bd.to_string()}")
        except Exception as e:  # mirror the reference's error-string results
            bdm.add(f"job {i} failed: {e!r}")
            if verbose:
                import traceback

                traceback.print_exc()
    return bdm
