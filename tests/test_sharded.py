"""Multi-device tests on the virtual 8-device CPU mesh (conftest sets
XLA_FLAGS=--xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from expann_tpu.models.brute_force import BruteForceEngine
from expann_tpu.models.build import BuildConfig
from expann_tpu.parallel.sharded import (
    build_sharded,
    make_mesh,
    replicated_query_dp,
    sharded_build_step,
    sharded_query_batch,
)


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


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_query_recall():
    x, q = _data(2400, 50, 32)
    k = 10
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    idx = build_sharded(x, BuildConfig(M=8, ef_construction=60), mesh)
    ans = sharded_query_batch(idx, q, k=k, ef=40)
    rec = _recall(ans, gt)
    assert rec >= 0.9, f"sharded recall {rec}"


def test_sharded_query_no_duplicate_global_ids():
    x, q = _data(1600, 20, 16, seed=2)
    mesh = make_mesh(8)
    idx = build_sharded(x, BuildConfig(M=8, ef_construction=40), mesh)
    ans = sharded_query_batch(idx, q, k=10, ef=30)
    for row in ans:
        real = row[(row >= 0) & (row < x.shape[0])]
        assert np.unique(real).size == real.size


def test_sharded_uneven_corpus():
    # n not divisible by 8: padding rows must never appear in results
    x, q = _data(1001, 10, 16, seed=3)
    mesh = make_mesh(8)
    idx = build_sharded(x, BuildConfig(M=8, ef_construction=40), mesh)
    ans = sharded_query_batch(idx, q, k=5, ef=20)
    assert (ans[ans >= 0] < 1001).all()


def test_sharded_build_step_matches_local_prune():
    """Distributed candidate generation must produce globally-exact top-C
    (exact kNN via per-shard matmul + allgather merge)."""
    x, _ = _data(800, 1, 16, seed=4)
    wave, _ = _data(16, 1, 16, seed=5)
    mesh = make_mesh(8)
    idx = build_sharded(x, BuildConfig(M=8, ef_construction=40), mesh)
    sel_ids, sel_d = sharded_build_step(
        idx.vectors,
        idx.norms,
        jnp.asarray(np.pad(wave, ((0, 0), (0, idx.vectors.shape[-1] - 16)))),
        C=32,
        cap=8,
        ortho_factor=0.5,
        ortho_bias=0.0,
        prune_overflow=0,
        n_shard=idx.n_shard,
        mesh=mesh,
        precision="highest",
    )
    sel_ids = np.asarray(sel_ids)
    # every wave vector's nearest neighbour must be its first selected edge
    d2 = ((wave[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    nn = d2.argmin(1)
    assert (sel_ids[:, 0] == nn).all()


def test_replicated_dp_query():
    x, q = _data(1200, 40, 16, seed=6)
    k = 5
    gt = _gt(x, q, k)
    from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine

    eng = AntitopoEngine(config=AntitopoConfig(M=8, ef_construction=60))
    eng.store_many_vectors(x)
    eng.build()
    mesh = make_mesh(8)
    ans = replicated_query_dp(eng.graph, q, k=k, ef=30, mesh=mesh)
    rec = _recall(ans, gt)
    assert rec >= 0.9, f"dp recall {rec}"


def test_sharded_index_has_stacked_upper_layers():
    """Per-shard upper layers are stacked per level; shards missing a
    level descend as a no-op (all-sentinel slots)."""
    x, q = _data(2400, 10, 16, seed=3)
    mesh = make_mesh(8)
    idx = build_sharded(x, BuildConfig(M=8, ef_construction=40), mesh)
    assert len(idx.layer_slots) >= 1  # 300 rows/shard, p=1/8 per level
    S = idx.num_shards
    for sl, al in zip(idx.layer_slots, idx.layer_adjs):
        assert sl.shape[0] == S and sl.shape[1] == idx.n_shard + 1
        assert al.shape[0] == S
        # slot values index adj rows (incl. the common sentinel row)
        assert int(jnp.max(sl)) <= al.shape[1] - 1
        # adjacency ids are local w/ sentinel n_shard
        assert int(jnp.max(al)) <= idx.n_shard


def test_sharded_flat_query_exact():
    from expann_tpu.parallel.sharded import build_sharded_flat, sharded_flat_query

    x, q = _data(2100, 24, 16, seed=7)
    k = 5
    gt = _gt(x, q, k)
    mesh = make_mesh(8)
    idx = build_sharded_flat(x, mesh)
    ans = sharded_flat_query(idx, q, k=k)
    rec = _recall(ans, gt)
    assert rec >= 0.95, f"sharded flat recall {rec}"
    assert (ans[ans >= 0] < 2100).all()
