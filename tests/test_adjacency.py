"""Adjacency-row invariants across ALL builders.

The reference's insert loop guards every reverse append with an
``edge_exists`` scan (src/antitopo_engine.h:442-450), so no adjacency row
ever holds the same neighbour twice and no row points at itself.  All
three builders (one-shot, wave, distributed) must uphold the same
invariants: duplicates would waste adjacency slots, inflate degree counts
and distcomp statistics.
"""

import numpy as np
import pytest

from expann_tpu.models.build import BuildConfig, build_index
from expann_tpu.parallel.distbuild import build_distributed
from expann_tpu.parallel.sharded import make_mesh


def _assert_adj_invariants(adj, sentinel, check_self=True):
    adj = np.asarray(adj)
    # no duplicate ids within any row (sentinel padding excluded)
    s = np.sort(adj, axis=1)
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] != sentinel)
    bad = np.nonzero(dup.any(axis=1))[0]
    assert bad.size == 0, (
        f"duplicate neighbour ids in rows {bad[:10]}: "
        f"{[sorted(adj[i][adj[i] != sentinel]) for i in bad[:3]]}"
    )
    if check_self:
        # no self-loops (rows indexed by the same id space as the entries)
        rows = np.arange(adj.shape[0])[:, None]
        self_loop = np.nonzero(
            ((adj == rows) & (rows != sentinel)).any(axis=1)
        )[0]
        assert self_loop.size == 0, f"self-loops in rows {self_loop[:10]}"
    # all ids in range
    assert adj.min() >= 0 and adj.max() <= sentinel


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("builder", ["oneshot", "wave"])
def test_local_builders_unique_rows(builder):
    x = _data(3000, 32, seed=3)
    cfg = BuildConfig(
        M=10, ef_construction=60, prune_cand=60,
        builder=builder, wave_size=512,
    )
    graph = build_index(x, cfg)
    _assert_adj_invariants(graph.adj_bottom, graph.sentinel)
    for layer in graph.layers:
        # upper layers store global ids but rows are slot-indexed, so the
        # row-index self-loop check does not apply
        _assert_adj_invariants(layer.adj[:-1], graph.sentinel, check_self=False)


@pytest.mark.parametrize("mode", ["oneshot", "incremental"])
def test_distributed_builder_unique_rows(mode):
    x = _data(3000, 32, seed=7)
    mesh = make_mesh(8)
    cfg = BuildConfig(M=8, ef_construction=48, prune_cand=48)
    graph, _ = build_distributed(
        x, cfg, mesh, wave_size=256, bootstrap=500, mode=mode
    )
    _assert_adj_invariants(graph.adj_bottom, graph.sentinel)
