"""End-to-end engine tests: recall gates against exact ground truth and
parity with the sequential oracle on small synthetic data."""

import numpy as np

from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu.models.brute_force import BruteForceEngine
from expann_tpu.models.refbuild import SequentialOracle


def _synthetic(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((m, d)).astype(np.float32),
    )


def _recall(ans, gt):
    m, k = gt.shape
    hits = 0
    for q in range(m):
        hits += len(set(int(v) for v in ans[q]) & set(int(v) for v in gt[q]))
    return hits / (m * k)


def _ground_truth(x, q, k):
    eng = BruteForceEngine()
    eng.store_many_vectors(x)
    eng.build()
    return eng.query_k_batch(q, k)


def test_engine_recall_small():
    x, q = _synthetic(2000, 100, 32)
    k = 10
    gt = _ground_truth(x, q, k)
    eng = AntitopoEngine(
        config=AntitopoConfig(M=16, ef_construction=100, ef_search_mult=4)
    )
    eng.store_many_vectors(x)
    eng.build()
    ans = eng.query_k_batch(q, k)
    rec = _recall(ans, gt)
    assert rec >= 0.9, f"recall {rec} too low"


def test_engine_no_duplicates():
    x, q = _synthetic(1000, 50, 16, seed=3)
    eng = AntitopoEngine(config=AntitopoConfig(M=8, ef_construction=50, ef_search_mult=3))
    eng.store_many_vectors(x)
    eng.build()
    ans = eng.query_k_batch(q, 10)
    for row in ans:
        real = row[row < eng.n]
        assert np.unique(real).size == real.size


def test_engine_matches_oracle_recall():
    """The batched one-shot build must be at least as good as the
    sequential-insert oracle at equal search width (SURVEY.md hard part 2:
    recall parity is the acceptance test, not graph isomorphism)."""
    x, q = _synthetic(2000, 80, 24, seed=5)
    k = 10
    ef = 40
    gt = _ground_truth(x, q, k)

    oracle = SequentialOracle(M=12, ef_construction=80)
    for row in x:
        oracle.store_vector(row)

    eng = AntitopoEngine(
        config=AntitopoConfig(M=12, ef_construction=80, ef_search=ef)
    )
    eng.store_many_vectors(x)
    eng.build()
    # parity across an ef sweep spanning the serving range (ef in
    # {20, 50, 100} on 2k points, within epsilon of the sequential
    # oracle), not just one operating point
    for ef_i in (20, 50, 100):
        oracle_rec = _recall(
            np.array([oracle.query_k(row, k, ef_search=ef_i) for row in q]),
            gt,
        )
        eng.set_ef_search(ef_i)
        rec = _recall(eng.query_k_batch(q, k), gt)
        assert rec >= oracle_rec - 0.03, (
            f"ef={ef_i}: engine {rec} vs oracle {oracle_rec}"
        )


def test_engine_distcomps_vs_oracle_selectivity():
    """Selectivity parity: at equal ef the batched
    graph's distance computations per query must stay within a constant
    factor of the sequential oracle's (RECORD_STATS num_distcomps,
    src/antitopo_engine.h:125-128).  The batched beam pays a fixed
    expand*R cost per iteration (visited-set masking instead of per-node
    skip), so some overhead is structural; it must be bounded, not free.
    Measured ~2.2x on this config."""
    x, q = _synthetic(1500, 80, 24, seed=7)
    k, ef = 10, 40

    oracle = SequentialOracle(M=12, ef_construction=80)
    for row in x:
        oracle.store_vector(row)
    oracle.num_distcomps = 0
    for row in q:
        oracle.query_k(row, k, ef_search=ef)
    oracle_dc = oracle.num_distcomps / len(q)
    assert oracle_dc > 0

    eng = AntitopoEngine(
        config=AntitopoConfig(M=12, ef_construction=80, ef_search=ef)
    )
    eng.store_many_vectors(x)
    eng.build()
    eng.set_ef_search(ef)  # resets counters
    eng.query_k_batch(q, k)
    eng_dc = eng.num_distcomps / len(q)
    assert eng_dc > 0
    assert eng_dc <= 4.0 * oracle_dc, (
        f"batched {eng_dc:.0f} vs oracle {oracle_dc:.0f} distcomps/query"
    )


def test_engine_compressed_path():
    # SIFT-like non-negative small-int vectors so cast-quantization is sane
    rng = np.random.default_rng(9)
    x = rng.integers(0, 200, (1500, 32)).astype(np.float32)
    q = rng.integers(0, 200, (60, 32)).astype(np.float32)
    k = 10
    gt = _ground_truth(x, q, k)
    eng = AntitopoEngine(
        config=AntitopoConfig(
            M=16, ef_construction=100, ef_search_mult=4, use_compression=True
        )
    )
    eng.store_many_vectors(x)
    eng.build()
    ans = eng.query_k_batch(q, k)
    rec = _recall(ans, gt)
    assert rec >= 0.85, f"compressed recall {rec} too low"
    assert eng.num_distcomps_compressed > 0


def test_engine_query_k_single():
    x, _ = _synthetic(500, 1, 16, seed=11)
    eng = AntitopoEngine(config=AntitopoConfig(M=8, ef_construction=40, ef_search_mult=4))
    eng.store_many_vectors(x)
    eng.build()
    assert eng.query_k(x[42], 1) == [42]
    assert eng.query_k_numpy(x[17], 1) == [17]


def test_param_list_schema():
    eng = AntitopoEngine(M=60, ef_construction=500, ortho_count=1,
                         prune_overflow=0, use_compression=False)
    pl = eng.param_list()
    for key in [
        "M", "M0", "ef_search_mult", "ef_construction", "ortho_count",
        "ortho_factor", "ortho_bias", "prune_overflow", "use_compression",
        "use_largest_direction_filtering", "num_distcomps",
        "num_distcomps_compressed",
    ]:
        assert key in pl
    assert pl["M0"] == "120"
    assert pl["ortho_factor"] == "0.500000"


def test_engine_ranged_quantization():
    # Gaussian data (negative values) — the ranged affine quantizer must
    # handle it where the cast quantizer clips (reference defines but never
    # instantiates quantizer_ranged_q8; here it is a live option)
    x, q = _synthetic(1500, 60, 32, seed=13)
    k = 10
    gt = _ground_truth(x, q, k)
    eng = AntitopoEngine(
        config=AntitopoConfig(
            M=16, ef_construction=100, ef_search_mult=4,
            use_compression=True, quant_mode="ranged",
        )
    )
    eng.store_many_vectors(x)
    eng.build()
    ans = eng.query_k_batch(q, k)
    rec = _recall(ans, gt)
    assert rec >= 0.85, f"ranged-quant recall {rec} too low"


def test_ortho_knn_scan_matches_numpy():
    """ortho_knn_device penalized scores must match a direct numpy
    evaluation of the reference scoring rule (src/antitopo_engine.h:342-351)."""
    import jax.numpy as jnp

    from expann_tpu.models.build import ortho_knn_device

    rng = np.random.default_rng(21)
    n, d = 64, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 112)))
    norms = (xp.astype(np.float64) ** 2).sum(1).astype(np.float32)
    chosen = rng.integers(0, n, (n, 2)).astype(np.int32)
    valid = np.ones((n, 2), bool)
    factor, bias = 0.5, 0.1

    ids, score = ortho_knn_device(
        jnp.asarray(xp), jnp.asarray(norms), jnp.asarray(chosen),
        jnp.asarray(valid), factor, bias,
        C=8, row_block=64, col_block=64, precision="highest",
    )
    ids = np.asarray(ids)
    score = np.asarray(score)

    d2 = ((x[:, None].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    for q in range(0, n, 7):
        s = d2[q].copy()
        for p in chosen[q]:
            co = d2[p]
            hit = co < d2[q]
            s = s + np.where(hit, factor * (d2[q] - co) + bias, 0.0)
        s[q] = np.inf
        order = np.argsort(s, kind="stable")[:8]
        np.testing.assert_allclose(
            score[q], np.sort(s)[:8], rtol=1e-4, atol=1e-3
        )
        assert set(ids[q].tolist()) == set(order.tolist())


def test_engine_ortho_count_2():
    x, q = _synthetic(1500, 60, 24, seed=31)
    k = 10
    gt = _ground_truth(x, q, k)
    eng = AntitopoEngine(
        config=AntitopoConfig(
            M=12, ef_construction=80, ef_search_mult=4, ortho_count=2
        )
    )
    eng.store_many_vectors(x)
    eng.build()
    rec = _recall(eng.query_k_batch(q, k), gt)
    assert rec >= 0.9, f"ortho_count=2 recall {rec}"
