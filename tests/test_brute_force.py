import numpy as np
import jax.numpy as jnp

from expann_tpu.models.brute_force import BruteForceEngine


def _np_knn(q, x, k):
    d = ((q[:, None, :].astype(np.float64) - x[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def test_brute_force_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    q = rng.standard_normal((17, 32)).astype(np.float32)
    eng = BruteForceEngine()
    eng.store_many_vectors(x)
    eng.build()
    got = eng.query_k_batch(q, 5)
    want = _np_knn(q, x, 5)
    # allow order flips on exact ties only (random floats: no ties expected)
    np.testing.assert_array_equal(got, want)


def test_brute_force_single_query_api():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 16)).astype(np.float32)
    eng = BruteForceEngine()
    for row in x:
        eng.store_vector(row)
    eng.build()
    ids = eng.query_k(x[7], 1)
    assert ids == [7]


def test_brute_force_normalize():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, 8)).astype(np.float32) * 10
    eng = BruteForceEngine()
    eng.store_many_vectors(x, take_norms=True)
    eng.build()
    q = x[3] / np.linalg.norm(x[3])
    assert eng.query_k(q, 1) == [3]


def test_brute_force_fused_pallas_mode():
    # the fused Pallas kernel runs in interpret mode on CPU (small case)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((512, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    eng = BruteForceEngine(mode="fused")
    eng.store_many_vectors(x)
    eng.build()
    got = eng.query_k_batch(q, 5)
    want = _np_knn(q, x, 5)
    # bf16 corpus: allow tiny disagreement on near-ties
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got, want)])
    assert agree >= 0.95, f"fused agreement {agree}"


def test_brute_force_fused_i8_mode():
    # centered int8 scan + exact f32 rerank (interpret mode on CPU)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((512, 32)) * 3 + 1.5).astype(np.float32)
    q = (rng.standard_normal((64, 32)) * 3 + 1.5).astype(np.float32)
    eng = BruteForceEngine(mode="fused_i8")
    eng.store_many_vectors(x)
    eng.build()
    got = eng.query_k_batch(q, 5)
    want = _np_knn(q, x, 5)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got, want)])
    assert agree >= 0.97, f"fused_i8 agreement {agree}"


def test_brute_force_fused_i8_bf16_rerank():
    # i8 scan + NEAR-exact bf16 rerank corpus (2 B/dim: half the device
    # memory of the f32 rerank corpus)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((512, 32)) * 3 + 1.5).astype(np.float32)
    q = (rng.standard_normal((64, 32)) * 3 + 1.5).astype(np.float32)
    eng = BruteForceEngine(mode="fused_i8", rerank_store="bf16")
    eng.store_many_vectors(x)
    eng.build()
    assert eng._x.dtype == jnp.bfloat16
    got = eng.query_k_batch(q, 5)
    want = _np_knn(q, x, 5)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got, want)])
    assert agree >= 0.95, f"fused_i8 bf16-rerank agreement {agree}"


def test_brute_force_fused_i8_query_wire():
    # query_wire='i8': 1 B/dim on the wire, rerank against the on-device
    # DEQUANTIZED query (models/brute_force._rerank_dequant) — the e2e
    # serving configuration when the host<->device link is the bottleneck
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((512, 32)) * 3 + 1.5).astype(np.float32)
    q = (rng.standard_normal((64, 32)) * 3 + 1.5).astype(np.float32)
    eng = BruteForceEngine(mode="fused_i8", query_wire="i8")
    eng.store_many_vectors(x)
    eng.build()
    got = eng.query_k_batch(q, 5)
    assert all(len(set(row.tolist())) == 5 for row in got), "dup answers"
    want = _np_knn(q, x, 5)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got, want)])
    assert agree >= 0.93, f"fused_i8 i8-wire agreement {agree}"


def _prepared(x, dtype=jnp.bfloat16):
    from expann_tpu.ops.pallas_topk import prepare_corpus

    return prepare_corpus(x, dtype)


def test_flat_topk_count_mode_parity():
    """The kernel's count-then-merge selection (merge a corpus block only
    as far as its candidates beat the running k-th distance) must return
    exactly the top-k of the bf16-rounded corpus: dup-free, ascending, and
    the same sets as an exhaustive sort of the same rounded distances —
    for a small and a full-width k over a ragged corpus."""
    import ml_dtypes

    from expann_tpu.ops.pallas_topk import flat_topk

    rng = np.random.default_rng(11)
    n, d, B = 1500, 64, 64  # n NOT a block multiple (pad masking)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    c = _prepared(x)
    xb = x.astype(ml_dtypes.bfloat16).astype(np.float64)
    qb = q.astype(ml_dtypes.bfloat16).astype(np.float64)
    d2 = ((qb[:, None] - xb[None]) ** 2).sum(-1)
    for k in (10, 100):
        ids, dd = flat_topk(jnp.asarray(q), c.x, c.norms, k=k)
        ids, dd = np.asarray(ids), np.asarray(dd)
        gt = np.argsort(d2, axis=1, kind="stable")[:, :k]
        kth = np.sort(d2, axis=1)[:, k - 1]
        for b in range(B):
            assert len(set(ids[b].tolist())) == k  # dup-free
            # every returned id is within the true k-th distance (exact up
            # to f32 accumulation of the bf16 products)
            assert (d2[b, ids[b]] <= kth[b] * (1 + 1e-5) + 1e-4).all(), (k, b)
            assert len(set(ids[b]) & set(gt[b])) >= k - 1
        assert (np.diff(dd, axis=1) >= 0).all()  # ascending
        np.testing.assert_allclose(
            dd, np.take_along_axis(d2, ids, axis=1), rtol=1e-4, atol=1e-3
        )


def test_flat_topk_count_mode_ties_dupfree():
    """Tie-heavy corpus (16x duplicated rows): ids must stay duplicate-free
    and the sorted distances must equal the exact sorted top-k distances."""
    from expann_tpu.ops.pallas_topk import flat_topk

    rng = np.random.default_rng(12)
    base = rng.integers(-4, 5, size=(40, 32)).astype(np.float32)
    x = np.concatenate([base] * 16)  # 640 rows, every distance 16x tied
    q = rng.integers(-4, 5, size=(64, 32)).astype(np.float32)
    k = 32
    c = _prepared(x)
    ids, dd = flat_topk(jnp.asarray(q), c.x, c.norms, k=k)
    ids, dd = np.asarray(ids), np.asarray(dd)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)  # small ints: bf16-exact
    for b in range(64):
        assert len(set(ids[b].tolist())) == k
    np.testing.assert_allclose(dd, np.sort(d2, axis=1)[:, :k], rtol=1e-6)


def test_flat_topk_count_mode_i8():
    """int8 codes (integer distances, frequent exact ties): the kernel must
    return the exact code-space top-k distances, duplicate-free."""
    from expann_tpu.ops.pallas_topk import flat_topk, quantize_query_i8

    rng = np.random.default_rng(13)
    x = (rng.standard_normal((700, 32)) * 2 + 0.5).astype(np.float32)
    q = (rng.standard_normal((64, 32)) * 2 + 0.5).astype(np.float32)
    c = _prepared(x, jnp.int8)
    qi = quantize_query_i8(q, c.center, c.scale)
    xi = np.asarray(c.x)[: x.shape[0], :32].astype(np.int64)
    d2 = ((qi.astype(np.int64)[:, None] - xi[None]) ** 2).sum(-1)
    k = 16
    ids, dd = flat_topk(jnp.asarray(qi), c.x, c.norms, k=k)
    ids, dd = np.asarray(ids), np.asarray(dd)
    for b in range(64):
        assert len(set(ids[b].tolist())) == k
    np.testing.assert_array_equal(dd, np.sort(d2, axis=1)[:, :k])
    np.testing.assert_array_equal(np.take_along_axis(d2, ids, axis=1), dd)
