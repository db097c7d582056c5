"""Recall / QPS measurement harness.

Counterpart of the reference's basic_bench (reference:
src/basic_bench.h:58-149): times store+build, runs the full query set,
computes recall as |ans intersect GT| / (m * k), asserts no duplicate
results ("Duplicates detected, engine is buggy", :98-104), and records
average (squared) distance of each top-1 answer.

One deliberate difference: queries run *batched* (the whole point of the
accelerator design), so time_per_query_ns is amortized wall-clock over the query set —
the same definition the reference uses (total loop time / m, :131-135), just
with a throughput-oriented engine underneath.
"""

from __future__ import annotations

import time

import numpy as np

from expann_tpu.bench.bench_data import BenchData
from expann_tpu.data.dataset import TestDataset
from expann_tpu.models.base import Engine


def get_benchmark_data(eng: Engine, ds: TestDataset) -> BenchData:
    ret = BenchData()

    t0 = time.perf_counter_ns()
    eng.store_many_vectors(ds.vecs)
    eng.build()
    t1 = time.perf_counter_ns()

    # one untimed warmup pass at the timed shapes: XLA compiles on first
    # dispatch (minutes-slow on remote-compile hosts); the reference is
    # ahead-of-time C++ with no compile step, so folding compilation into
    # time_per_query_ns would measure the compiler, not the engine
    eng.query_k_batch(ds.queries, ds.k)
    eng.reset_stats()  # warmup must not inflate the distcomp counters

    t_q0 = time.perf_counter_ns()
    ans = eng.query_k_batch(ds.queries, ds.k)  # (m, k)
    t_q1 = time.perf_counter_ns()

    m, k = ds.m, ds.k
    assert ans.shape[0] == m

    # duplicate detection (src/basic_bench.h:98-104); ids outside [0, n)
    # are padding sentinels (-1 or n), not duplicates
    valid = (ans >= 0) & (ans < ds.n)
    for q in range(m):
        row = ans[q][valid[q]]
        if np.unique(row).size != row.size:
            raise AssertionError("Duplicates detected, engine is buggy.")

    gt = ds.ground_truth
    assert gt.shape[1] == k
    num_best_found = 0
    avg_d = 0.0
    avg_d2 = 0.0
    for q in range(m):
        row = set(int(v) for v in ans[q][valid[q]])
        num_best_found += len(row.intersection(int(v) for v in gt[q]))
        if ans[q].size and valid[q].any():
            top1 = int(ans[q][valid[q]][0])
            diff = ds.queries[q].astype(np.float64) - ds.vecs[top1].astype(
                np.float64
            )
            d2 = float(np.dot(diff, diff))
            avg_d += np.sqrt(d2)
            avg_d2 += d2

    ret.time_per_query_ns = (t_q1 - t_q0) / m
    ret.time_to_build_ns = float(t1 - t0)
    ret.average_distance = avg_d / m
    ret.average_squared_distance = avg_d2 / m
    ret.recall = num_best_found / (m * k)
    ret.engine_name = eng.name()
    ret.param_list = eng.param_list()
    return ret
