"""The XLA gather beam (models/search.query_batch) through the engine:
recall against the exact oracle and duplicate-free results, over the
beam expansion width, ef and the compressed (uint8 codes + f32 rerank)
path."""

import numpy as np
import pytest

from expann_tpu.data.loader import generate_sift_like
from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu.models.brute_force import BruteForceEngine

N, K = 1500, 10


@pytest.fixture(scope="module")
def built():
    # u8-valued vectors: the compressed path's uint8 codes hold them exactly
    x, q = generate_sift_like(N, 48, 32, seed=5)
    oracle = BruteForceEngine()
    oracle.store_many_vectors(x)
    oracle.build()
    gt = oracle.query_k_batch(q, K)
    eng = AntitopoEngine(config=AntitopoConfig(M=10, ef_construction=80))
    eng.store_many_vectors(x)
    eng.build()
    return eng, q, gt


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("ef", [16, 48])
@pytest.mark.parametrize("expand", [1, 2, 4])
def test_xla_beam_recall_no_duplicates(built, expand, ef, compressed):
    eng, q, gt = built
    eng.cfg.query_expand = expand
    eng.cfg.use_compression = compressed
    if compressed and eng.graph.codes is None:
        eng._attach_codes()
    eng.set_ef_search(ef)
    ids = eng.query_k_batch(q, K)
    assert ids.shape == (len(q), K)
    for row in ids:
        valid = row[(row >= 0) & (row < N)]
        assert len(valid) == K
        assert len(set(valid.tolist())) == K
    rec = np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)])
    assert rec >= (0.8 if ef == 16 else 0.93), rec
    assert eng.num_distcomps > 0
    if compressed:
        assert eng.num_distcomps_compressed > 0
