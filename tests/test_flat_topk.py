"""The flat_topk kernel (Triton route; the Pallas interpreter on CPU)
against the exact oracle, and its wrapper's layout, tiles and splits."""

import jax.numpy as jnp
import numpy as np
import pytest

from expann_tpu.models.brute_force import BruteForceEngine
from expann_tpu.ops import pallas_topk as pt


def _oracle(x, q, k):
    eng = BruteForceEngine(mode="exact")
    eng.store_many_vectors(x)
    eng.build()
    return eng.query_k_batch(q, k)


@pytest.mark.parametrize("dtype", ["bf16", "i8"])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("n,b", [(1000, 33), (5000, 70)])
def test_kernel_matches_exact_oracle(dtype, k, n, b):
    """Ragged N (not a block multiple) and B (not a tile multiple).  Small
    integer-valued vectors are exact in bf16; int8 is checked in its own
    code space (the oracle runs over the codes), so in both cases the
    kernel must return the oracle's exact distances."""
    rng = np.random.default_rng(n + k)
    x = rng.integers(-6, 7, (n, 24)).astype(np.float32)
    q = rng.integers(-6, 7, (b, 24)).astype(np.float32)
    if dtype == "i8":
        c = pt.prepare_corpus(x, jnp.int8)
        qk = jnp.asarray(pt.quantize_query_i8(q, c.center, c.scale))
        x = np.asarray(c.x[:n, :24], np.float32)
        q = np.asarray(qk, np.float32)
    else:
        c = pt.prepare_corpus(x, jnp.bfloat16)
        qk = jnp.asarray(q)
    ids, d = pt.flat_topk(qk, c.x, c.norms, k=k)
    ids, d = np.asarray(ids), np.asarray(d)
    assert ids.shape == (b, k) and d.shape == (b, k)
    assert ((ids >= 0) & (ids < n)).all()
    assert all(len(set(r.tolist())) == k for r in ids)
    gt = _oracle(x, q, k)
    full = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    want = np.take_along_axis(full, gt, 1)  # oracle distances, ascending
    got = np.take_along_axis(full, ids, 1)
    # same distance multiset at every rank: ids agree up to exact ties
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(d, want)


def test_kernel_fewer_rows_than_k_marks_empty_slots():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    c = pt.prepare_corpus(x)
    ids, d = pt.flat_topk(jnp.asarray(x[:3]), c.x, c.norms, k=10)
    ids, d = np.asarray(ids), np.asarray(d)
    assert sorted(ids[0, :5].tolist()) == list(range(5))
    assert (ids[:, 5:] == c.x.shape[0]).all() and np.isinf(d[:, 5:]).all()


def test_kernel_rejects_k_above_max():
    c = pt.prepare_corpus(np.ones((10, 8), np.float32))
    with pytest.raises(AssertionError):
        pt.flat_topk(jnp.ones((4, 8)), c.x, c.norms, k=pt.MAX_K + 1)


def test_int8_corpus_requires_int8_queries():
    c = pt.prepare_corpus(np.ones((10, 8), np.float32), jnp.int8)
    with pytest.raises(AssertionError):
        pt.flat_topk(jnp.ones((4, 8)), c.x, c.norms, k=2)


@pytest.mark.parametrize(
    "n,d,min_rows", [(1, 3, 0), (4096, 128, 0), (5000, 100, 0), (10, 200, 9000)]
)
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8])
def test_prepare_corpus_layout(n, d, min_rows, dtype):
    x = np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)
    c = pt.prepare_corpus(x, dtype, min_rows=min_rows)
    rows, width = c.x.shape
    assert c.x.dtype == dtype and c.n == n
    assert rows % pt.ROW_ALIGN == 0 and rows >= max(n, min_rows)
    assert width >= max(d, 32) and width & (width - 1) == 0
    norms = np.asarray(c.norms)
    assert np.isinf(norms[n:]).all() and np.isfinite(norms[:n]).all()
    stored = np.asarray(c.x[:n], np.float32)
    np.testing.assert_allclose(norms[:n], (stored * stored).sum(1), rtol=1e-5)
    assert (stored[:, d:] == 0).all()


@pytest.mark.parametrize("k", [1, 10, 16, 17, 64, 100, 128])
def test_tiles_fit_registers(k):
    Bt, G, K = pt._tiles(k)
    assert K >= k and K & (K - 1) == 0
    assert min(Bt, G) >= 16  # tensor-core operand minimum
    threads = 32 * pt.NUM_WARPS
    # running list (distances + ids) plus the block's scores, per thread
    assert (2 * Bt * K + Bt * G) // threads <= 160


@pytest.mark.parametrize("b,n_pad", [(64, 1 << 20), (4096, 1 << 20), (65536, 4096)])
def test_splits_fill_the_card_and_divide_the_corpus(b, n_pad):
    Bt, G, _ = pt._tiles(10)
    tiles = -(-b // Bt)
    s = pt._splits(tiles, n_pad, G)
    assert n_pad % (s * G) == 0
    if tiles >= pt.TARGET_PROGRAMS:
        assert s == 1  # the query tiles alone fill the card
    else:
        assert s * tiles >= pt.TARGET_PROGRAMS


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_oracle(gpu):
    """The kernel as compiled for the card (no interpreter) against the
    exact oracle at a real width: bf16-exact integer vectors, 100k rows."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 16, (100_000, 128)).astype(np.float32)
    q = rng.integers(0, 16, (300, 128)).astype(np.float32)
    c = pt.prepare_corpus(x)
    for k in (10, 128):
        ids, d = pt.flat_topk(jnp.asarray(q), c.x, c.norms, k=k)
        gt = _oracle(x, q, k)
        full = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
        want = np.take_along_axis(full, gt, 1)
        np.testing.assert_array_equal(np.asarray(d), want)
        np.testing.assert_array_equal(np.take_along_axis(full, np.asarray(ids), 1), want)
