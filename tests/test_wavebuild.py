"""Wave-batched incremental builder: recall gate vs exact ground truth and
agreement with the one-shot builder's quality."""

import numpy as np

from expann_tpu.models.antitopo import AntitopoConfig, AntitopoEngine
from expann_tpu.models.brute_force import BruteForceEngine
from expann_tpu.models.build import BuildConfig, build_index
from expann_tpu.models.search import query_batch
from expann_tpu.models.wavebuild import build_index_wave

import jax.numpy as jnp


def _data(n, m, d, seed=0):
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


def _gt(x, q, k):
    eng = BruteForceEngine()
    eng.store_many_vectors(x)
    eng.build()
    return eng.query_k_batch(q, k)


def test_wave_build_recall_parity_with_oneshot():
    x, q = _data(4000, 80, 32)
    k = 10
    ef = 40
    gt = _gt(x, q, k)
    cfg = BuildConfig(M=12, ef_construction=80, prune_cand=64)

    g_one = build_index(x, cfg)
    ids_one, _, _ = query_batch(g_one, jnp.asarray(np.pad(q, ((0, 0), (0, 96)))), k=k, ef=ef)
    rec_one = _recall(np.asarray(ids_one), gt)

    g_wave = build_index_wave(x, cfg, wave_size=512, bootstrap=1024)
    ids_wave, _, _ = query_batch(g_wave, jnp.asarray(np.pad(q, ((0, 0), (0, 96)))), k=k, ef=ef)
    rec_wave = _recall(np.asarray(ids_wave), gt)

    assert rec_wave >= 0.85, f"wave recall {rec_wave}"
    assert rec_wave >= rec_one - 0.08, f"wave {rec_wave} vs oneshot {rec_one}"


def test_wave_build_ortho_count_recall_parity_with_oneshot():
    """ortho_count=2 construction (multi-pass penalized candidate search,
    reference src/antitopo_engine.h:396-423) must hold recall parity with
    the one-shot builder's exact ortho passes."""
    x, q = _data(4000, 80, 32, seed=3)
    k = 10
    ef = 40
    gt = _gt(x, q, k)
    cfg = BuildConfig(M=12, ef_construction=80, prune_cand=64, ortho_count=2)

    g_one = build_index(x, cfg)
    ids_one, _, _ = query_batch(
        g_one, jnp.asarray(np.pad(q, ((0, 0), (0, 96)))), k=k, ef=ef
    )
    rec_one = _recall(np.asarray(ids_one), gt)

    g_wave = build_index_wave(x, cfg, wave_size=512, bootstrap=1024)
    ids_wave, _, _ = query_batch(
        g_wave, jnp.asarray(np.pad(q, ((0, 0), (0, 96)))), k=k, ef=ef
    )
    rec_wave = _recall(np.asarray(ids_wave), gt)

    assert rec_wave >= 0.85, f"wave ortho recall {rec_wave}"
    assert rec_wave >= rec_one - 0.08, f"wave {rec_wave} vs oneshot {rec_one}"


def test_wave_build_edge_caps_respected():
    x, _ = _data(3000, 1, 16, seed=1)
    cfg = BuildConfig(M=8, ef_construction=60, prune_cand=48)
    g = build_index_wave(x, cfg, wave_size=512, bootstrap=512)
    adj = np.asarray(g.adj_bottom)[:3000]
    deg = (adj != 3000).sum(1)
    assert deg.max() <= cfg.M0, f"max degree {deg.max()} exceeds M0={cfg.M0}"
    # every real row should have at least one edge
    assert deg.min() >= 1


def test_wave_build_via_engine_builder_flag():
    x, q = _data(2500, 40, 24, seed=2)
    k = 5
    gt = _gt(x, q, k)
    eng = AntitopoEngine(
        config=AntitopoConfig(
            M=10, ef_construction=60, ef_search=30, builder="wave", wave_size=512
        )
    )
    eng.store_many_vectors(x)
    eng.build()
    ans = eng.query_k_batch(q, k)
    rec = _recall(ans, gt)
    assert rec >= 0.85, f"engine wave recall {rec}"


def test_wave_hierarchy_routing_isolated():
    """Isolate the hierarchy-construction divergence (wave builder: bottom
    layer Vamana-style first, upper layers RECONSTRUCTED afterwards,
    models/wavebuild.py:16-22 — the reference constructs *through* the
    hierarchy, src/antitopo_engine.h:333-414).

    The hierarchy's only serving role is routing: it picks the bottom
    beam's entry points.  So compare the bottom-layer beam run from
    (a) the reconstructed hierarchy's greedy-descent entries against
    (b) ORACLE entries (each query's true nearest corpus point — the best
    any router could do).  If (a) tracks (b) within a small margin, the
    after-the-fact hierarchy routes as well as a perfect router and the
    end-recall gap vs the reference is attributable to the bottom graph,
    not the hierarchy divergence."""
    from expann_tpu.models.search import (
        beam_search,
        greedy_descent,
        squared_norms,
    )

    x, q = _data(6000, 100, 32, seed=7)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    cfg = BuildConfig(M=12, ef_construction=80, prune_cand=64)
    g = build_index_wave(x, cfg, wave_size=512, bootstrap=1024)
    assert len(g.layers) >= 1, "need a real hierarchy to isolate"

    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))
    qn = squared_norms(qp)
    B = qp.shape[0]

    def bottom_recall(ep_ids):
        ids, _, _ = beam_search(
            g.vectors, g.norms, g.adj_bottom, qp, qn, ep_ids,
            ef=ef, max_iters=8 * ef + 16, sentinel=g.sentinel,
        )
        return _recall(np.asarray(ids[:, :k]), gt)

    # (a) entries from the reconstructed hierarchy's greedy descent
    from expann_tpu.models.search import _gather_dist2

    ep = jnp.full((B,), g.starting_vertex, jnp.int32)
    ep_d = _gather_dist2(g.vectors, g.norms, ep[:, None], qp, qn, "highest")[:, 0]
    for layer in reversed(g.layers):
        ep, ep_d = greedy_descent(
            g.vectors, g.norms, layer.slot, layer.adj, qp, qn, ep, ep_d,
            "highest",
        )
    rec_hier = bottom_recall(ep[:, None])

    # (b) oracle entries: the true nearest corpus point per query
    rec_oracle = bottom_recall(jnp.asarray(gt[:, :1].astype(np.int32)))

    assert rec_hier >= 0.85, f"hierarchy-routed recall {rec_hier}"
    assert rec_hier >= rec_oracle - 0.03, (
        f"hierarchy routing loses {rec_oracle - rec_hier:.3f} recall vs "
        f"oracle entries ({rec_hier} vs {rec_oracle})"
    )


def test_extend_index_wave_accumulates():
    """store -> build -> store -> build must ACCUMULATE (the reference
    inserts at store time, src/antitopo_engine.h:310-330, so a second
    build continues from the live graph).  The extended index must (a)
    contain both corpora, (b) hold recall parity with a from-scratch
    build of the combined corpus."""
    from expann_tpu.models.wavebuild import extend_index_wave

    x_all, q = _data(4000, 80, 32, seed=11)
    x0, x1 = x_all[:2500], x_all[2500:]
    k, ef = 10, 40
    gt = _gt(x_all, q, k)
    cfg = BuildConfig(M=12, ef_construction=80, prune_cand=64)

    g0 = build_index_wave(x0, cfg, wave_size=512, bootstrap=1024)
    g_ext = extend_index_wave(g0, x1, cfg, wave_size=512)
    assert g_ext.n == 4000
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))
    ids_ext, _, _ = query_batch(g_ext, qp, k=k, ef=ef)
    rec_ext = _recall(np.asarray(ids_ext), gt)

    g_full = build_index_wave(x_all, cfg, wave_size=512, bootstrap=1024)
    ids_full, _, _ = query_batch(g_full, qp, k=k, ef=ef)
    rec_full = _recall(np.asarray(ids_full), gt)

    # results must span BOTH halves of the corpus
    flat = np.asarray(ids_ext).ravel()
    flat = flat[flat >= 0]
    assert (flat < 2500).any() and (flat >= 2500).any()

    assert rec_ext >= 0.85, f"extended recall {rec_ext}"
    assert rec_ext >= rec_full - 0.08, (
        f"extended {rec_ext} vs from-scratch {rec_full}"
    )

    # degree caps hold everywhere after extension
    adj = np.asarray(g_ext.adj_bottom)[:4000]
    deg = (adj != 4000).sum(1)
    assert deg.max() <= cfg.M0
    # no duplicate ids in any adjacency row
    for row, d_ in zip(adj, deg):
        real = row[row != 4000]
        assert len(set(real.tolist())) == d_


def test_engine_store_build_store_build():
    """Engine-level reference-parity flow: a second store+build round
    extends the index instead of dropping the first corpus."""
    x_all, q = _data(3000, 40, 24, seed=12)
    x0, x1 = x_all[:2000], x_all[2000:]
    k = 5
    gt = _gt(x_all, q, k)
    eng = AntitopoEngine(
        config=AntitopoConfig(
            M=10, ef_construction=60, ef_search=30, builder="wave",
            wave_size=512,
        )
    )
    eng.store_many_vectors(x0)
    eng.build()
    assert eng.n == 2000
    eng.store_many_vectors(x1)
    eng.build()
    assert eng.n == 3000
    ans = eng.query_k_batch(q, k)
    rec = _recall(ans, gt)
    flat = np.asarray(ans).ravel()
    flat = flat[flat >= 0]
    assert (flat >= 2000).any(), "second-round vectors never returned"
    assert rec >= 0.85, f"store-build-store-build recall {rec}"


def test_refine_pass_improves_weak_prefix():
    """Two-pass refinement (models/wavebuild.refine_index_wave):
    re-inserting the early waves against the FINAL graph must not lose
    recall, and on a build whose early nodes saw only a tiny bootstrap it
    should recover quality (two-pass Vamana semantics; reference insert
    search + prune: src/antitopo_engine.h:396-455)."""
    from expann_tpu.models.wavebuild import refine_index_wave

    x, q = _data(4000, 80, 32, seed=3)
    k, ef = 10, 40
    gt = _gt(x, q, k)
    qp = jnp.asarray(np.pad(q, ((0, 0), (0, 96))))
    # deliberately weak incremental regime: tiny bootstrap, small waves
    cfg = BuildConfig(M=12, ef_construction=80, prune_cand=64)
    g = build_index_wave(x, cfg, wave_size=256, bootstrap=128)
    ids0, _, _ = query_batch(g, qp, k=k, ef=ef)
    rec0 = _recall(np.asarray(ids0), gt)

    g2 = refine_index_wave(g, cfg, frac=0.5, wave_size=512)
    ids1, _, _ = query_batch(g2, qp, k=k, ef=ef)
    rec1 = _recall(np.asarray(ids1), gt)

    # refined rows are a prune over old ∪ fresh candidates — never worse
    # beyond noise, and materially better on the weak prefix
    assert rec1 >= rec0 - 0.01, (rec0, rec1)
    assert rec1 >= 0.85, (rec0, rec1)


def test_refine_pass_row_invariants():
    """Refined adjacency keeps the structural invariants: no self-loops,
    no duplicate edges in a row, all degrees <= M0, sentinel padding."""
    from expann_tpu.models.wavebuild import refine_index_wave

    x, _ = _data(2000, 8, 32, seed=9)
    cfg = BuildConfig(M=10, ef_construction=60, prune_cand=48)
    g = build_index_wave(x, cfg, wave_size=256, bootstrap=256)
    g2 = refine_index_wave(g, cfg, frac=1.0, wave_size=512)
    n = g2.n
    adj = np.asarray(g2.adj_bottom)[:n]
    cap = cfg.M0
    for i in range(n):
        live = adj[i][adj[i] != n]
        assert (live != i).all(), f"self-loop at {i}"
        assert len(set(live.tolist())) == live.size, f"dup edge at {i}"
        assert live.size <= cap, (i, live.size)
