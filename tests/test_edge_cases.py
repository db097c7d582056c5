"""API edge cases: tiny corpora, k near n, input validation."""

import numpy as np
import pytest

from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu.models.brute_force import BruteForceEngine


def test_brute_force_k_equals_n():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    eng = BruteForceEngine()
    eng.store_many_vectors(x)
    eng.build()
    ids = eng.query_k_batch(x[:2], 16)
    for row in ids:
        assert sorted(int(v) for v in row) == list(range(16))


def test_antitopo_tiny_corpus():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    eng = AntitopoEngine(config=AntitopoConfig(M=4, ef_construction=8, ef_search=8))
    eng.store_many_vectors(x)
    eng.build()
    ids = eng.query_k(x[2], 3)
    assert ids[0] == 2
    assert len(set(ids)) == len(ids)


def test_antitopo_single_vector():
    eng = AntitopoEngine(config=AntitopoConfig(M=4, ef_construction=8))
    eng.store_vector(np.ones(8, np.float32))
    eng.build()
    assert eng.query_k(np.ones(8, np.float32), 1) == [0]


def test_antitopo_k_exceeds_n_returns_all_real():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    eng = AntitopoEngine(config=AntitopoConfig(M=4, ef_construction=8, ef_search=16))
    eng.store_many_vectors(x)
    eng.build()
    ids = eng.query_k(x[0], 10)  # only 6 real vectors exist
    assert len(ids) <= 6
    assert ids[0] == 0
    assert all(0 <= i < 6 for i in ids)


def test_reject_non_2d_inputs():
    eng = AntitopoEngine(config=AntitopoConfig(M=4, ef_construction=8))
    with pytest.raises(ValueError):
        eng.store_many_vectors(np.ones(8, np.float32))
    eng.store_many_vectors(np.ones((10, 8), np.float32))
    eng.build()
    with pytest.raises(ValueError):
        eng.query_k_batch(np.ones(8, np.float32), 2)


def test_build_without_vectors_raises():
    eng = AntitopoEngine(config=AntitopoConfig(M=4, ef_construction=8))
    with pytest.raises(AssertionError):
        eng.build()
