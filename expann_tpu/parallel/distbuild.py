"""Distributed construction of ONE global graph over a device mesh.

``build_sharded`` (parallel/sharded.py) builds S independent sub-indexes
and merges their results at query time.  This module instead builds a
single global anti-topo graph whose edges cross shards — the integrated
distributed build loop (SURVEY.md section 5 "Distributed communication
backend"; the reference has no distributed counterpart, its insert loop is
src/antitopo_engine.h:310-465):

  * the corpus and the global adjacency are row-sharded over the mesh:
    ``(S, n_shard + 1, ...)`` arrays with ``NamedSharding(P("shard"))``;
    adjacency entries are GLOBAL ids (``shard * n_shard + local``),
  * inserts proceed in waves against the already-inserted prefix
    (``frontier`` masking), exactly like models/wavebuild.py — but
    candidate generation is *corpus-sharded and dense-exact*: every device
    scores the replicated wave against its shard and the per-shard top-C
    lists are all-gathered and merged (one-shot-quality candidates at 1/S
    the per-device cost),
  * the anti-topo prune runs replicated on the merged candidates (W and C
    are small); forward rows are scattered to the wave nodes' owning
    shards and reverse edges to the destinations' owning shards — XLA
    inserts the cross-shard collectives from the sharding annotations,
  * the fullest rows are re-pruned each wave (deferred lazy prune,
    reference src/antitopo_engine.h:270-307), with a final sweep.

The result is assembled into a standard single-graph ``GraphIndex`` (the
graph serves on one device, or replicated over a mesh via
replicated_query_dp).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P, Mesh

from expann_tpu.models.build import (
    BuildConfig,
    _build_layer,
    _round_up,
    build_upper_layers,
    draw_levels,
)
from expann_tpu.models.graph import GraphIndex, make_corpus
from expann_tpu.models.prune import antitopo_prune, pairwise_co_dist
from expann_tpu.ops.distance import pairwise_dist2, squared_norms
from expann_tpu.parallel.sharded import AXIS, make_mesh

INF = jnp.inf


def _g2sl(gid, n_shard: int, S: int):
    """Global id -> (shard, local); the global sentinel S*n_shard maps to
    the last shard's sentinel row (whose stored norm is +inf)."""
    shard = jnp.minimum(gid // n_shard, S - 1)
    local = jnp.where(gid >= S * n_shard, n_shard, gid % n_shard)
    return shard, local


def _gather_vec(vectors, norms, gid, n_shard: int):
    """Gather (vec, norm) rows of global ids from the sharded corpus; XLA
    inserts the cross-shard collectives."""
    S = vectors.shape[0]
    s, l = _g2sl(gid, n_shard, S)
    return vectors[s, l], norms[s, l]


@functools.partial(
    jax.jit,
    static_argnames=("C", "cap", "prune_overflow", "overflow_rows",
                     "n_shard", "n_total", "mesh", "precision", "reverse",
                     "ortho_count"),
    donate_argnums=(2, 3),
)
def _dist_wave_step(
    vectors, norms, adj, counts, wave_q, wave_gids, frontier,
    C: int, cap: int, ortho_factor, ortho_bias, prune_overflow: int,
    overflow_rows: int, n_shard: int, mesh: Mesh, precision: str,
    reverse: bool = True,
    xs_flat=None,
    n_total: int = 0,
    ortho_count: int = 1,
):
    """One fused distributed insert wave (single dispatch; adjacency and
    counts donated).  ``wave_q``: (W, D) replicated wave vectors;
    ``wave_gids``: (W,) global ids (GSENT padding); ``frontier``: only
    global ids < frontier are candidate targets (pass n for one-shot
    waves — the wave node itself is always excluded).

    Candidate generation per shard is either a dense scored sort (small
    shards / incremental mode) or, when ``xs_flat`` (the shard corpora laid
    out for the flat scan: bf16 rows and their norms) is given, the
    flat_topk kernel — O(C) memory per wave regardless of shard size,
    which is what makes million-row single-device builds practical."""
    S = vectors.shape[0]
    GSENT = S * n_shard
    W = wave_q.shape[0]
    R = adj.shape[-1]

    if xs_flat is None:
        # ---- dense candidate generation (sorts (W, n_shard)) ----
        # With ortho_count > 1 the pass structure mirrors the reference's
        # per-insert construction loop (src/antitopo_engine.h:396-423) in
        # its dense-exact form (models/build.ortho_knn_device): pass 0 is
        # the plain scored sort; pass i >= 1 penalizes candidates that lie
        # closer to the previously chosen entry points (each pass's
        # first-place result, deduplicated) than to the new vertex, and the
        # union keeps each id's best carried score.  All passes run inside
        # this one dispatch; only the dense path supports it (the flat
        # Pallas scan scores raw distances only).
        def per_shard(vec, nrm, wq, wgids, frontier, pv, pn, pvalid):
            vec, nrm = vec[0], nrm[0]
            qn = squared_norms(wq)
            d2 = pairwise_dist2(
                wq, vec[:n_shard], x_norms=nrm[:n_shard], q_norms=qn,
                precision=precision,
            )
            score = d2
            if pv.shape[1] > 0:
                co_dots = jnp.einsum(
                    "wod,nd->won", pv, vec[:n_shard],
                    preferred_element_type=jnp.float32, precision=precision,
                )
                co = pn[:, :, None] + nrm[None, None, :n_shard] - 2.0 * co_dots
                hit = (co < d2[:, None, :]) & pvalid[:, :, None]
                pen = jnp.where(
                    hit, ortho_factor * (d2[:, None, :] - co) + ortho_bias, 0.0
                )
                score = d2 + jnp.sum(pen, axis=1)
            shard_id = jax.lax.axis_index(AXIS)
            lids = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
            gid = shard_id * n_shard + lids
            score = jnp.where(
                (gid < frontier) & (gid != wgids[:, None]), score, INF
            )
            d2s, gids_s = jax.lax.sort((score, gid), num_keys=1)
            return gids_s[:, :C][None], d2s[:, :C][None]

        shard_gen = jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(), P(), P(), P(), P(), P()),
            out_specs=(P(AXIS), P(AXIS)),
        )

        def gen_pass(chosen, chosen_valid):
            # chosen: (W, OC) global ids of previously chosen entry points
            # (OC may be 0 for the plain pass); vectors gathered replicated
            pv, pn = _gather_vec(vectors, norms, chosen, n_shard)
            return shard_gen(
                vectors, norms, wave_q, wave_gids, frontier,
                pv, pn, chosen_valid,
            )

        empty = jnp.zeros((W, 0), jnp.int32)
        gids, gd = gen_pass(empty, jnp.zeros((W, 0), bool))
    else:
        # ---- flat-scan candidates ----
        from expann_tpu.ops.pallas_topk import MAX_K, ROW_ALIGN, flat_topk

        def per_shard_flat(xsb, xnb, wq, wgids, frontier):
            xsb, xnb = xsb[0], xnb[0]  # (n_flat_pad, D) bf16, (n_flat_pad,)
            # rows at or past the frontier score +inf (not inserted yet)
            rows = jax.lax.broadcasted_iota(jnp.int32, xnb.shape, 0)
            row_gid = jax.lax.axis_index(AXIS) * n_shard + rows
            xnb = jnp.where(row_gid < frontier, xnb, INF)
            # flat_topk keeps at most MAX_K per list; wider candidate lists
            # (efc up to ~500) scan the shard in segments and merge the
            # per-segment top-(<=MAX_K) lists.  The corpus is read once
            # either way; NOTE this is an APPROXIMATION relative to the
            # dense path when C+1 > MAX_K: a segment contributes at most
            # its top-MAX_K, so if more than MAX_K of the true top-(C+1)
            # fall in one segment the excess are dropped.  For C=300 over
            # n_seg>=3 segments of shuffled data the binomial tail makes
            # that vanishingly rare, and the prune only needs *good*
            # candidates, not an exact top-C (recall parity vs the dense
            # builder is test-gated).
            n_seg = (C + 1 + MAX_K - 1) // MAX_K
            seg_rows = xsb.shape[0] // n_seg
            seg_rows += (-seg_rows) % ROW_ALIGN
            kk = min(C + 1, MAX_K)
            parts = []
            for si in range(n_seg):
                s0 = si * seg_rows
                s1 = min(s0 + seg_rows, xsb.shape[0])
                if s0 >= xsb.shape[0]:
                    break
                ids_s, d_s = flat_topk(wq, xsb[s0:s1], xnb[s0:s1], k=kk)
                parts.append((d_s, ids_s + s0))
            if len(parts) == 1:
                d, ids = parts[0]
            else:
                d = jnp.concatenate([p[0] for p in parts], axis=1)
                ids = jnp.concatenate([p[1] for p in parts], axis=1)
            if d.shape[1] < C:
                # tiny shards can cover the whole corpus in fewer segments
                # than C needs; pad to the fixed output width
                padw = C - d.shape[1]
                d = jnp.pad(d, ((0, 0), (0, padw)), constant_values=INF)
                ids = jnp.pad(
                    ids, ((0, 0), (0, padw)), constant_values=n_shard
                )
            shard_id = jax.lax.axis_index(AXIS)
            gid = ids + shard_id * n_shard
            # mask padding rows (they score +inf) and self; the last
            # shard's real row count is below n_shard
            real = jnp.clip(n_total - shard_id * n_shard, 0, n_shard)
            bad = (ids >= real) | (gid == wgids[:, None])
            d = jnp.where(bad, INF, d)
            gid = jnp.where(bad, GSENT, gid)
            d, gid = jax.lax.sort((d, gid), num_keys=1)
            return gid[:, :C][None], d[:, :C][None]

        gids, gd = jax.shard_map(
            per_shard_flat,
            mesh=mesh,
            in_specs=(P(AXIS), P(AXIS), P(), P(), P()),
            out_specs=(P(AXIS), P(AXIS)),
            check_vma=False,  # pallas outputs carry no vma metadata
        )(*xs_flat, wave_q, wave_gids, frontier)
    def merge_shard_lists(gids, gd):
        cat_d = jnp.transpose(gd, (1, 0, 2)).reshape(W, S * C)
        cat_i = jnp.transpose(gids, (1, 0, 2)).reshape(W, S * C)
        cat_d, cat_i = jax.lax.sort((cat_d, cat_i), num_keys=1)
        cd, ci = cat_d[:, :C], cat_i[:, :C]
        return jnp.where(jnp.isfinite(cd), ci, GSENT), cd

    cand_ids, cand_d = merge_shard_lists(gids, gd)

    if ortho_count > 1:
        assert xs_flat is None, (
            "ortho_count > 1 requires dense candidate generation"
        )
        all_ids, all_d = [cand_ids], [cand_d]
        chosen_cols = [cand_ids[:, 0]]
        for i in range(1, ortho_count):
            chosen = jnp.stack(chosen_cols, axis=1)  # (W, i)
            valid_cols = [jnp.ones((W,), bool)]
            for jj in range(1, i):
                dupj = jnp.zeros((W,), bool)
                for kk in range(jj):
                    dupj = dupj | (chosen_cols[jj] == chosen_cols[kk])
                valid_cols.append(~dupj)
            gids_i, gd_i = gen_pass(chosen, jnp.stack(valid_cols, axis=1))
            ids_i, d_i = merge_shard_lists(gids_i, gd_i)
            all_ids.append(ids_i)
            all_d.append(d_i)
            chosen_cols.append(ids_i[:, 0])
        # union keeping each id's best carried score (penalized passes
        # carry penalized scores into the prune, like the reference)
        u_i = jnp.concatenate(all_ids, axis=1)
        u_d = jnp.concatenate(all_d, axis=1)
        u_i, u_d = jax.lax.sort((u_i, u_d), num_keys=2)
        rep = jnp.concatenate(
            [jnp.zeros((W, 1), bool), u_i[:, 1:] == u_i[:, :-1]], axis=1
        )
        u_d = jnp.where(rep, INF, u_d)
        u_i = jnp.where(rep, GSENT, u_i)
        cand_d, cand_ids = jax.lax.sort((u_d, u_i), num_keys=2)
        cand_d, cand_ids = cand_d[:, :C], cand_ids[:, :C]

    # ---- replicated anti-topo prune of the merged candidates ----
    cvecs, cnorms = _gather_vec(vectors, norms, cand_ids, n_shard)
    cnorms = jnp.where(jnp.isfinite(cand_d), cnorms, INF)
    co = pairwise_co_dist(cvecs, cnorms, precision)
    sel_ids, sel_d = antitopo_prune(
        cand_ids, cand_d, co,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=GSENT,
    )

    # ---- forward rows to the wave nodes' owning shards ----
    row = jnp.full((W, R), GSENT, jnp.int32).at[:, :cap].set(sel_ids)
    ws, wl = _g2sl(wave_gids, n_shard, S)
    ws = jnp.where(wave_gids >= GSENT, S, ws)  # padding -> dropped
    adj = adj.at[ws, wl].set(row, mode="drop")
    counts = counts.at[ws, wl].set(
        jnp.sum(sel_ids != GSENT, axis=1), mode="drop"
    )
    if not reverse:
        return adj, counts

    adj, counts = _reverse_scatter(
        adj, counts, wave_gids, sel_ids, sel_d, n_shard
    )

    # ---- deferred lazy prune of the fullest rows ----
    flat_counts = counts[:, :n_shard].reshape(-1)
    top_counts, rows = jax.lax.top_k(flat_counts, overflow_rows)
    rows = jnp.where(top_counts > cap, rows, GSENT)
    adj, counts = _dist_overflow_prune(
        vectors, norms, adj, counts, rows,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, n_shard=n_shard, precision=precision,
    )
    return adj, counts


@functools.partial(
    jax.jit,
    static_argnames=("cap", "prune_overflow", "overflow_rows",
                     "n_shard", "precision"),
    donate_argnums=(2, 3),
)
def _dist_reverse_step(
    vectors, norms, adj, counts, wave_gids,
    cap: int, ortho_factor, ortho_bias, prune_overflow: int,
    overflow_rows: int, n_shard: int, precision: str,
):
    """One-shot phase 2: read the wave nodes' (already final) forward rows,
    recompute their edge distances, append the reverse edges to the
    destinations' owning shards, then re-prune the fullest rows.  Mirrors
    the one-shot builder's reverse pass (models/build.py) — no per-wave
    edge-list storage is needed because distances are recomputable."""
    S = vectors.shape[0]
    GSENT = S * n_shard
    ws, wl = _g2sl(wave_gids, n_shard, S)
    fwd = adj[ws, wl][:, :cap]  # (W, cap) global ids
    fwd = jnp.where(wave_gids[:, None] >= GSENT, GSENT, fwd)
    qv, qn = _gather_vec(vectors, norms, wave_gids, n_shard)
    dv, dn = _gather_vec(vectors, norms, fwd, n_shard)
    sel_d = (
        qn[:, None]
        + dn
        - 2.0
        * jnp.einsum("wd,wcd->wc", qv, dv, preferred_element_type=jnp.float32)
    )
    sel_d = jnp.where(fwd == GSENT, INF, sel_d)
    adj, counts = _reverse_scatter(adj, counts, wave_gids, fwd, sel_d, n_shard)

    flat_counts = counts[:, :n_shard].reshape(-1)
    top_counts, rows = jax.lax.top_k(flat_counts, overflow_rows)
    rows = jnp.where(top_counts > cap, rows, GSENT)
    return _dist_overflow_prune(
        vectors, norms, adj, counts, rows,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, n_shard=n_shard, precision=precision,
    )


def _reverse_scatter(adj, counts, src_gids, sel_ids, sel_d, n_shard: int):
    """Append reverse edges (dst <- src) into free adjacency slots of the
    destinations' owning shards (sort-grouped, same scheme as
    models/wavebuild._reverse_append)."""
    S = adj.shape[0]
    GSENT = S * n_shard
    W, cap = sel_ids.shape
    R = adj.shape[-1]
    src = jnp.broadcast_to(src_gids[:, None], (W, cap)).reshape(-1)
    dst = sel_ids.reshape(-1)
    d = sel_d.reshape(-1)
    dst = jnp.where(jnp.isfinite(d) & (src < GSENT), dst, GSENT)
    dst_s, d_s, src_s = jax.lax.sort((dst, d, src), num_keys=3)
    first = jnp.concatenate([jnp.ones((1,), bool), dst_s[1:] != dst_s[:-1]])
    idx = jnp.arange(dst_s.shape[0], dtype=jnp.int32)
    group_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, idx, 0)
    )
    ds_, dl_ = _g2sl(dst_s, n_shard, S)
    # edge_exists dedup (reference src/antitopo_engine.h:442-450): a
    # reverse edge dst<-src is skipped when src is already in dst's row —
    # in one-shot phase 2 every forward row exists before the reverse
    # pass, so mutual-kNN pairs hit this constantly; duplicates would
    # waste adjacency slots and inflate counts.  Surviving edges are
    # re-ranked within their destination group so writes stay contiguous.
    exists = (adj[ds_, dl_] == src_s[:, None]).any(-1)
    keep = (dst_s != GSENT) & ~exists
    kint = keep.astype(jnp.int32)
    ecs = jnp.cumsum(kint) - kint  # exclusive prefix count of kept edges
    pos = ecs - ecs[group_start]
    write_pos = counts[ds_, dl_] + pos
    ok = keep & (write_pos < R)
    ds_w = jnp.where(ok, ds_, S)  # drop out-of-range rows
    adj = adj.at[ds_w, dl_, jnp.minimum(write_pos, R - 1)].set(
        src_s, mode="drop"
    )
    counts = counts.at[ds_w, dl_].add(jnp.where(ok, 1, 0), mode="drop")
    return adj, counts


def _dist_overflow_prune(
    vectors, norms, adj, counts, rows,
    cap: int, ortho_factor, ortho_bias, prune_overflow: int,
    n_shard: int, precision: str,
):
    """Re-prune a padded batch of global rows over their full edge lists
    (rows == GSENT are padding and dropped on write)."""
    S = vectors.shape[0]
    GSENT = S * n_shard
    R = adj.shape[-1]
    rs, rl = _g2sl(rows, n_shard, S)
    cand_ids = adj[rs, rl]  # (P, R) global ids
    q, qn = _gather_vec(vectors, norms, rows, n_shard)
    cand_d_v, cand_n = _gather_vec(vectors, norms, cand_ids, n_shard)
    cand_d = (
        qn[:, None]
        + cand_n
        - 2.0
        * jnp.einsum(
            "pd,prd->pr", q, cand_d_v, preferred_element_type=jnp.float32
        )
    )
    cand_d = jnp.where(cand_ids == GSENT, INF, cand_d)
    cand_d, cand_ids = jax.lax.sort((cand_d, cand_ids), num_keys=2)
    cvecs, cnorms = _gather_vec(vectors, norms, cand_ids, n_shard)
    cnorms = jnp.where(jnp.isfinite(cand_d), cnorms, INF)
    co = pairwise_co_dist(cvecs, cnorms, precision)
    sel_ids, _ = antitopo_prune(
        cand_ids, cand_d, co,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=GSENT,
    )
    new_rows = jnp.full((rows.shape[0], R), GSENT, jnp.int32)
    new_rows = new_rows.at[:, :cap].set(sel_ids)
    rs_w = jnp.where(rows >= GSENT, S, rs)
    adj = adj.at[rs_w, rl].set(new_rows, mode="drop")
    counts = counts.at[rs_w, rl].set(
        jnp.sum(sel_ids != GSENT, axis=1), mode="drop"
    )
    return adj, counts


_dist_overflow_prune_jit = jax.jit(
    _dist_overflow_prune,
    static_argnames=("cap", "prune_overflow", "n_shard", "precision"),
    donate_argnums=(2, 3),
)


def build_distributed(
    x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
    mesh: Optional[Mesh] = None,
    wave_size: int = 1024,
    bootstrap: int = 2048,
    slack: int = 64,
    mode: str = "oneshot",
    candidates: str = "auto",
    verbose: bool = False,
) -> Tuple[GraphIndex, dict]:
    """Build one global graph with mesh-parallel waves.  Returns the
    assembled single-graph ``GraphIndex`` plus a stats dict.

    ``mode='oneshot'`` (default): candidates are dense-exact over the WHOLE
    corpus (insertion-order-free, one-shot quality) — phase 1 writes every
    node's pruned forward row, phase 2 derives the reverse edges from the
    final forward rows.  ``mode='incremental'`` mirrors the reference's
    insertion semantics: a one-shot bootstrap prefix, then waves whose
    candidates come only from already-inserted nodes (frontier masking).
    On clustered corpora the one-shot mode's exact whole-corpus candidates
    stay inside each cluster and leave the graph in many disconnected
    components; the incremental mode's early waves link across clusters,
    as the reference's insert-at-a-time build does.

    ``candidates``: 'dense' sorts a full (W, n_shard) score matrix per
    wave (exact; fine for small shards), 'flat' scans the corpus with the
    flat_topk kernel (O(C) memory — required for million-row shards;
    near-exact bf16 scoring), 'auto' picks 'flat' when the shard exceeds
    64k rows."""
    assert mode in ("oneshot", "incremental")
    assert candidates in ("auto", "dense", "flat")
    cfg = cfg or BuildConfig()
    mesh = mesh or make_mesh()
    S = mesh.devices.size
    x = np.asarray(x, np.float32)
    n, d = x.shape
    n_shard = (n + S - 1) // S
    GSENT = S * n_shard
    cap = cfg.M0
    R = _round_up(cap + slack, 16)
    C = min(cfg.prune_cand, cfg.ef_construction) if cfg.prune_cand else min(
        cfg.ef_construction, 4 * cap
    )

    # sharded corpus: per-shard (n_shard + 1) rows, +inf-norm sentinel row;
    # the last shard's unfilled rows are unreachable +inf-norm padding
    vecs_full, norms_full = make_corpus(x)  # (n + 1, D_pad)
    D_pad = vecs_full.shape[1]
    v_host = np.zeros((S, n_shard + 1, D_pad), np.float32)
    n_host = np.full((S, n_shard + 1), np.inf, np.float32)
    vf = np.asarray(vecs_full[:n])
    nf = np.asarray(norms_full[:n])
    for s in range(S):
        part = vf[s * n_shard : (s + 1) * n_shard]
        v_host[s, : part.shape[0]] = part
        n_host[s, : part.shape[0]] = nf[s * n_shard : s * n_shard + part.shape[0]]
    sharding = NamedSharding(mesh, P(AXIS))
    vectors = jax.device_put(jnp.asarray(v_host), sharding)
    norms = jax.device_put(jnp.asarray(n_host), sharding)
    adj = jax.device_put(
        jnp.full((S, n_shard + 1, R), GSENT, jnp.int32), sharding
    )
    counts = jax.device_put(jnp.zeros((S, n_shard + 1), jnp.int32), sharding)

    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)

    if mode == "incremental":
        # ---- bootstrap: exact one-shot on the first n0 rows (shard 0) ----
        n0 = min(n, max(bootstrap, 2 * cap), n_shard)
        boot = _build_layer(vecs_full[:n0], norms_full[:n0], cap=cap, cfg=cfg)
        boot_rows = np.full((n0, R), GSENT, np.int32)
        bootR = boot.shape[1]
        boot_np = np.asarray(boot)
        boot_rows[:, :bootR] = np.where(boot_np == n0, GSENT, boot_np)
        adj = adj.at[0, :n0].set(jnp.asarray(boot_rows))
        counts = counts.at[0, :n0].set(
            jnp.asarray((boot_rows != GSENT).sum(1).astype(np.int32))
        )
    else:
        n0 = 0

    if candidates == "auto":
        candidates = "flat" if n_shard > 65536 else "dense"
    if cfg.ortho_count > 1 and candidates == "flat":
        # the penalized multi-pass search needs dense per-shard scoring
        # (the flat Pallas scan ranks raw distances only)
        candidates = "dense"
    xs_flat = None
    if candidates == "flat":
        from expann_tpu.ops.pallas_topk import prepare_corpus

        parts = [
            prepare_corpus(vf[s * n_shard : (s + 1) * n_shard], min_rows=n_shard)
            for s in range(S)
        ]
        xs_flat = (
            jax.device_put(jnp.stack([p.x for p in parts]), sharding),
            jax.device_put(jnp.stack([p.norms for p in parts]), sharding),
        )
        del parts

    def waves(start):
        i = start
        while i < n:
            W = min(wave_size, n - i)
            gids_np = np.arange(i, i + W, dtype=np.int32)
            if W < wave_size:
                gids_np = np.concatenate(
                    [gids_np, np.full(wave_size - W, GSENT, np.int32)]
                )
            wq = np.zeros((gids_np.shape[0], D_pad), np.float32)
            wq[:W] = vf[i : i + W]
            yield jnp.asarray(wq), jnp.asarray(gids_np), i
            i += W

    # ---- phase 1: candidates + prune + forward rows ----
    for wq, gids_j, i in waves(n0):
        frontier = jnp.int32(i if mode == "incremental" else n)
        adj, counts = _dist_wave_step(
            vectors, norms, adj, counts, wq, gids_j, frontier,
            C=C, cap=cap, ortho_factor=cfg.ortho_factor,
            ortho_bias=cfg.ortho_bias, prune_overflow=cfg.prune_overflow,
            overflow_rows=min(128, S * n_shard), n_shard=n_shard, mesh=mesh,
            precision=cfg.precision, reverse=(mode == "incremental"),
            xs_flat=xs_flat, n_total=n, ortho_count=cfg.ortho_count,
        )
        # one wave in flight at a time: the host waits for each wave
        # before dispatching the next (whether overlapping waves pays is
        # an open A/B, ROADMAP speed queue)
        jax.block_until_ready(counts)
        if verbose:
            print(f"distributed build fwd: {i}/{n}", flush=True)

    # ---- phase 2 (one-shot): reverse edges from the final forward rows ----
    if mode == "oneshot":
        for _, gids_j, i in waves(0):
            adj, counts = _dist_reverse_step(
                vectors, norms, adj, counts, gids_j,
                cap=cap, ortho_factor=cfg.ortho_factor,
                ortho_bias=cfg.ortho_bias,
                prune_overflow=cfg.prune_overflow,
                overflow_rows=min(128, S * n_shard), n_shard=n_shard,
                precision=cfg.precision,
            )
            jax.block_until_ready(counts)  # one wave in flight (see phase 1)
            if verbose:
                print(f"distributed build rev: {i}/{n}", flush=True)

    # ---- final sweep: enforce the cap everywhere ----
    # flattened (shard, local<n_shard) index IS the global id
    counts_np = np.asarray(counts)[:, :n_shard].reshape(-1)
    over = np.nonzero(counts_np > cap)[0].astype(np.int32)
    Pb = 128
    for r0 in range(0, over.size, Pb):
        rows = over[r0 : r0 + Pb]
        if rows.size < Pb:
            rows = np.concatenate(
                [rows, np.full(Pb - rows.size, GSENT, np.int32)]
            )
        adj, counts = _dist_overflow_prune_jit(
            vectors, norms, adj, counts, jnp.asarray(rows),
            cap=cap, ortho_factor=cfg.ortho_factor,
            ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            n_shard=n_shard, precision=cfg.precision,
        )

    # ---- assemble the single global graph ----
    adj_np = np.asarray(adj)  # (S, n_shard + 1, R)
    R0 = _round_up(cap, 16)
    rows = adj_np[:, :n_shard, :R0].reshape(S * n_shard, R0)[:n]
    # ids >= n can only be last-shard padding rows or GSENT -> sentinel n
    rows = np.where(rows >= n, n, rows).astype(np.int32)
    adj_bottom = np.concatenate(
        [rows, np.full((1, R0), n, np.int32)], axis=0
    )

    upper = build_upper_layers(vecs_full, norms_full, levels, max_layer, cfg)
    n_med = max(n0, min(n, 4096))
    mean = vf[:n_med].mean(0, keepdims=True)
    medoid = int(np.argmin(((vf[:n_med] - mean) ** 2).sum(1)))
    if upper:
        members = np.nonzero(levels >= max_layer - 1)[0]
        sv = int(members[0]) if members.size else medoid
    else:
        sv = medoid

    graph = GraphIndex(
        vectors=vecs_full,
        norms=norms_full,
        adj_bottom=jnp.asarray(adj_bottom),
        layers=upper,
        starting_vertex=jnp.int32(sv),
    )
    stats = {"n_shards": S, "n_shard": n_shard, "candidates": candidates,
             "waves": (n - n0 + wave_size - 1) // wave_size}
    return graph, stats
