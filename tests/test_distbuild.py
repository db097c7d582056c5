"""Distributed single-global-graph construction on the 8-device CPU mesh.

Gate: the integrated distributed build loop must produce
ONE global graph competitive with build_sharded's union-of-subindexes at
equal ef.  Note the caveat at this toy scale (n=4000 over 8 shards): each
500-row sub-index beam with ef=40 is nearly exhaustive, so the union's
recall (~0.998 here) approaches brute force and exceeds what ANY single
graph of the same degree reaches (one-shot single-device: ~0.91) — the fair
single-graph bars are the one-shot and wave builders, and the
union-vs-global tradeoff flips at production scale where per-shard
sub-searches are no longer exhaustive.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from expann_tpu.models.brute_force import BruteForceEngine
from expann_tpu.models.build import BuildConfig, build_index
from expann_tpu.models.search import query_batch
from expann_tpu.parallel.distbuild import build_distributed
from expann_tpu.parallel.sharded import make_mesh


def _recall(ans, gt):
    m, k = gt.shape
    hits = 0
    for q in range(m):
        hits += len(set(int(v) for v in ans[q]) & set(int(v) for v in gt[q]))
    return hits / (m * k)


def _data(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((m, d)).astype(np.float32),
    )


def _gt(x, q, k):
    eng = BruteForceEngine()
    eng.store_many_vectors(x)
    eng.build()
    return eng.query_k_batch(q, k)


def test_distributed_build_flat_candidates():
    """Streamed flat_topk candidate generation (the million-row path) must
    track the dense-exact path's recall at toy scale (interpret mode)."""
    x, q = _data(2048, 40, 32, seed=5)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    cfg = BuildConfig(M=8, ef_construction=48, prune_cand=48)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))

    recs = {}
    for cand in ("dense", "flat"):
        graph, stats = build_distributed(
            x, cfg, mesh, wave_size=256, mode="oneshot", candidates=cand
        )
        assert stats["candidates"] == cand
        ids, _, _ = query_batch(graph, qp, k=k, ef=ef)
        recs[cand] = _recall(np.asarray(ids), gt)
    assert recs["flat"] >= recs["dense"] - 0.05, recs
    assert recs["flat"] >= 0.8, recs


def test_distributed_build_flat_wide_candidates():
    """Candidate lists wider than flat_topk's k<=128 cap scan the corpus
    in segments and merge (enables efc up to ~500 at the million-row
    scale); recall must track the dense path at the same width."""
    x, q = _data(2048, 30, 32, seed=8)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    cfg = BuildConfig(M=8, ef_construction=160, prune_cand=160)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))

    recs = {}
    for cand in ("dense", "flat"):
        graph, stats = build_distributed(
            x, cfg, mesh, wave_size=256, mode="oneshot", candidates=cand
        )
        ids, _, _ = query_batch(graph, qp, k=k, ef=ef)
        recs[cand] = _recall(np.asarray(ids), gt)
    assert recs["flat"] >= recs["dense"] - 0.05, recs
    assert recs["flat"] >= 0.8, recs


def test_distributed_build_ortho2_parity():
    """ortho_count=2 in the distributed builder (multi-pass penalized
    candidate generation, reference src/antitopo_engine.h:396-423) must
    track the wave builder's recall at the same ortho_count — the parity
    gate for the newest builder's semantic completeness."""
    from expann_tpu.models.wavebuild import build_index_wave

    x, q = _data(3000, 50, 32, seed=11)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    cfg = BuildConfig(M=10, ef_construction=80, prune_cand=64, ortho_count=2)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))

    g_dist, stats = build_distributed(
        x, cfg, mesh, wave_size=512, bootstrap=500, mode="incremental"
    )
    assert stats["candidates"] == "dense"
    ids_d, _, _ = query_batch(g_dist, qp, k=k, ef=ef)
    rec_dist = _recall(np.asarray(ids_d), gt)

    g_wave = build_index_wave(x, cfg, wave_size=512, bootstrap=500)
    ids_w, _, _ = query_batch(g_wave, qp, k=k, ef=ef)
    rec_wave = _recall(np.asarray(ids_w), gt)

    assert rec_dist >= 0.85, rec_dist
    assert rec_dist >= rec_wave - 0.05, (rec_dist, rec_wave)


@pytest.mark.parametrize("mode", ["oneshot", "incremental"])
def test_distributed_build_one_global_graph(mode):
    x, q = _data(4000, 60, 32)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    cfg = BuildConfig(M=10, ef_construction=80, prune_cand=64)

    graph, stats = build_distributed(
        x, cfg, mesh, wave_size=512, bootstrap=500, mode=mode
    )
    assert stats["n_shards"] == 8

    # it is ONE graph: bottom adjacency covers all rows and contains
    # cross-shard edges
    adj = np.asarray(graph.adj_bottom)[:4000]
    deg = (adj != 4000).sum(1)
    assert deg.min() >= 1
    assert deg.max() <= cfg.M0
    n_shard = stats["n_shard"]
    src_shard = np.arange(4000)[:, None] // n_shard
    dst_shard = np.where(adj == 4000, -1, adj // n_shard)
    cross = (dst_shard >= 0) & (dst_shard != src_shard)
    assert cross.any(), "no cross-shard edges — not a global graph"

    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))
    ids, _, _ = query_batch(graph, qp, k=k, ef=ef)
    rec_global = _recall(np.asarray(ids), gt)

    # single-graph bar: the one-shot builder on one chip (see module
    # docstring for why the exhaustive toy-scale union is not the bar)
    g_one = build_index(x, cfg)
    ids_one, _, _ = query_batch(g_one, qp, k=k, ef=ef)
    rec_one = _recall(np.asarray(ids_one), gt)

    assert rec_global >= 0.85, f"global-graph recall {rec_global}"
    if mode == "oneshot":
        assert rec_global >= rec_one - 0.03, (rec_global, rec_one)
    else:
        assert rec_global >= rec_one - 0.08, (rec_global, rec_one)


def test_builder_dist_route_matches_oneshot():
    """`BuildConfig.builder="dist"` routes build_index through the
    distributed builder on a 1-device mesh (the route "auto" takes for
    large corpora, models/build.py); its graph must serve within a few
    recall points of the one-shot builder at equal ef."""
    x, q = _data(3000, 50, 32, seed=3)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    cfg_dist = BuildConfig(M=10, ef_construction=80, prune_cand=64,
                           builder="dist")
    g_dist = build_index(x, cfg_dist)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))
    ids, _, _ = query_batch(g_dist, qp, k=k, ef=ef)
    rec_dist = _recall(np.asarray(ids), gt)

    cfg_one = BuildConfig(M=10, ef_construction=80, prune_cand=64,
                          builder="oneshot")
    g_one = build_index(x, cfg_one)
    ids_one, _, _ = query_batch(g_one, qp, k=k, ef=ef)
    rec_one = _recall(np.asarray(ids_one), gt)

    assert rec_dist >= rec_one - 0.03, (rec_dist, rec_one)


def test_distributed_build_incremental_flat_candidates():
    """Flat-scan candidates in incremental mode (the route builder="auto"
    takes above 131k rows) honor the insertion frontier: rows not yet
    inserted score +inf, so the graph must track the dense-exact
    incremental build's recall and keep the adjacency invariants."""
    x, q = _data(2048, 40, 32, seed=6)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    cfg = BuildConfig(M=8, ef_construction=48, prune_cand=48)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))

    recs = {}
    for cand in ("dense", "flat"):
        graph, stats = build_distributed(
            x, cfg, mesh, wave_size=256, bootstrap=256,
            mode="incremental", candidates=cand,
        )
        assert stats["candidates"] == cand
        adj = np.asarray(graph.adj_bottom)[:2048]
        assert ((adj == 2048) | (adj < 2048)).all()
        ids, _, _ = query_batch(graph, qp, k=k, ef=ef)
        recs[cand] = _recall(np.asarray(ids), gt)
    assert recs["flat"] >= recs["dense"] - 0.02, recs
    assert recs["flat"] >= 0.8, recs
