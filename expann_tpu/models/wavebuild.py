"""Scalable incremental construction: wave-batched graph inserts.

The reference inserts one vector at a time — beam-search the current graph
for ef_construction candidates, anti-topo prune, append reverse edges with
lazy pruning (reference: src/antitopo_engine.h:310-465).  That serial chain
cannot use a lockstep machine; the one-shot builder (models/build.py) fixes
this with exact all-pairs candidates but costs O(N^2) distance work.  This
module is the scalable middle path (SURVEY.md section 7 step 4): process
vectors in *waves* of W inserts against the already-built prefix, with the
whole wave — candidate beam search, anti-topo prune, forward-edge scatter,
reverse-edge grouping, and overflow re-prune — fused into ONE jitted,
buffer-donating device dispatch.

Design deviations from the reference, chosen for the hardware:
  * wave members link only to the prefix, never to each other (the first
    bootstrap block is built exactly with the one-shot builder instead),
  * construction runs on the bottom layer only, Vamana-style, from a fixed
    medoid entry point; the tiny upper HNSW layers (expected N/M^l members)
    are built one-shot afterwards for query-time descent — during
    construction a wide beam from a fixed entry reaches the same
    neighbourhoods the hierarchy would shortcut to,
  * the deferred lazy prune handles the (up to) ``overflow_rows`` fullest
    destinations per wave inside the fused step; stragglers are caught by
    later waves and a final sweep.  (The reference prunes each destination
    immediately upon exceeding the cap, src/antitopo_engine.h:270-273 —
    deferral to wave granularity is a controlled divergence; recall parity
    is the gate.)
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from expann_tpu.models.build import (
    BuildConfig,
    _build_layer,
    _round_up,
    build_upper_layers,
    draw_levels,
)
from expann_tpu.models.graph import GraphIndex, make_corpus
from expann_tpu.models.prune import antitopo_prune, pairwise_co_dist
from expann_tpu.models.search import beam_search, _gather_dist2
from expann_tpu.ops.distance import squared_norms

INF = jnp.inf


def _write_forward(adj, counts, wave_ids, sel_ids, cap: int, sentinel: int):
    """Scatter each wave node's pruned forward edges into its adjacency row."""
    W = wave_ids.shape[0]
    R = adj.shape[1]
    row = jnp.full((W, R), sentinel, jnp.int32)
    row = row.at[:, :cap].set(sel_ids)
    safe = jnp.where(wave_ids == sentinel, adj.shape[0], wave_ids)
    adj = adj.at[safe].set(row, mode="drop")
    counts = counts.at[safe].set(
        jnp.sum(sel_ids != sentinel, axis=1), mode="drop"
    )
    return adj, counts


def _reverse_append(adj, counts, wave_ids, sel_ids, sel_d, sentinel: int):
    """Append reverse edges (dst -> new wave node) into free adjacency slots.

    One device sort groups the (dst, d, src) edge list by destination; each
    edge's write position is counts[dst] + rank-within-group.  Edges that
    would exceed the row width are dropped (they lost the per-wave closeness
    race); counts are bumped by the number actually written.  Mirrors the
    reference's per-insert appends (src/antitopo_engine.h:441-455).
    """
    W, cap = sel_ids.shape
    R = adj.shape[1]
    src = jnp.broadcast_to(wave_ids[:, None], (W, cap)).reshape(-1)
    dst = sel_ids.reshape(-1)
    d = sel_d.reshape(-1)
    dst = jnp.where(jnp.isfinite(d) & (src != sentinel), dst, sentinel)
    dst_s, d_s, src_s = jax.lax.sort((dst, d, src), num_keys=3)
    first = jnp.concatenate([jnp.ones((1,), bool), dst_s[1:] != dst_s[:-1]])
    idx = jnp.arange(dst_s.shape[0], dtype=jnp.int32)
    group_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, idx, 0)
    )
    # edge_exists dedup (reference src/antitopo_engine.h:442-450): drop a
    # reverse edge whose src is already present in dst's row (the wave
    # node's forward write above, or a mutual pair), then re-rank the
    # surviving edges within each destination group so writes stay
    # contiguous and counts stay exact
    exists = (adj[jnp.minimum(dst_s, sentinel)] == src_s[:, None]).any(-1)
    keep = (dst_s != sentinel) & ~exists
    kint = keep.astype(jnp.int32)
    ecs = jnp.cumsum(kint) - kint  # exclusive prefix count of kept edges
    pos = ecs - ecs[group_start]
    write_pos = counts[dst_s] + pos
    ok = keep & (write_pos < R)
    oob = adj.shape[0]
    rows = jnp.where(ok, dst_s, oob)
    adj = adj.at[rows, jnp.minimum(write_pos, R - 1)].set(src_s, mode="drop")
    counts = counts.at[rows].add(jnp.where(ok, 1, 0), mode="drop")
    return adj, counts


def _overflow_prune(
    vectors, norms, adj, counts, rows,
    cap: int, ortho_factor, ortho_bias, prune_overflow: int,
    sentinel: int, precision: str,
):
    """Re-prune a padded batch of rows over their full current edge lists
    (the deferred lazy-prune, reference src/antitopo_engine.h:270-307).
    Rows equal to ``sentinel`` are padding and are dropped on write."""
    safe_read = jnp.minimum(rows, sentinel)
    cand_ids = adj[safe_read]  # (P, R)
    q = vectors[safe_read]
    qn = norms[safe_read]
    cand_d = _gather_dist2(vectors, norms, cand_ids, q, qn, precision)
    cand_d = jnp.where(cand_ids == sentinel, INF, cand_d)
    cand_d, cand_ids = jax.lax.sort((cand_d, cand_ids), num_keys=2)
    cvecs = vectors[cand_ids]
    cnorms = jnp.where(jnp.isfinite(cand_d), norms[cand_ids], INF)
    co = pairwise_co_dist(cvecs, cnorms, precision)
    sel_ids, _ = antitopo_prune(
        cand_ids, cand_d, co,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=sentinel,
    )
    R = adj.shape[1]
    new_rows = jnp.full((rows.shape[0], R), sentinel, jnp.int32)
    new_rows = new_rows.at[:, :cap].set(sel_ids)
    safe_rows = jnp.where(rows >= sentinel, adj.shape[0], rows)
    adj = adj.at[safe_rows].set(new_rows, mode="drop")
    counts = counts.at[safe_rows].set(
        jnp.sum(sel_ids != sentinel, axis=1), mode="drop"
    )
    return adj, counts


@functools.partial(
    jax.jit,
    donate_argnums=(2, 3),
    static_argnames=(
        "cap", "C", "ef_c", "max_iters", "prune_overflow", "overflow_rows",
        "precision", "expand", "sentinel", "ortho_count",
    ),
)
def _wave_step(
    vectors, norms, adj, counts, wave_ids, medoid,
    cap: int, C: int, ef_c: int, max_iters: int,
    ortho_factor, ortho_bias, prune_overflow: int,
    overflow_rows: int, precision: str, expand: int, sentinel: int,
    ortho_count: int = 1,
):
    """One fused wave insert: beam-search candidates against the prefix,
    anti-topo prune, scatter forward + reverse edges, re-prune the fullest
    destinations.  Single dispatch; adjacency and counts buffers donated.

    With ``ortho_count > 1``, each wave node runs that many beam searches:
    pass i >= 1 scores with the ortho penalty against the first-place
    results of previous passes, is seeded by the previous pass's beam, and
    the candidate union (each id keeping its best carried score) feeds the
    prune — mirroring the reference's per-insert construction loop
    (src/antitopo_engine.h:396-423; like the reference, penalized passes
    carry penalized scores into the prune)."""
    wq = vectors[jnp.minimum(wave_ids, sentinel)]
    wqn = norms[jnp.minimum(wave_ids, sentinel)]
    W = wave_ids.shape[0]

    ep = jnp.broadcast_to(medoid, (W,)).astype(jnp.int32)[:, None]
    cand_ids, cand_d, _ = beam_search(
        vectors, norms, adj, wq, wqn, ep,
        ef=ef_c, max_iters=max_iters, sentinel=sentinel,
        precision=precision, expand=expand,
    )

    if ortho_count > 1:
        all_ids, all_d = [cand_ids], [cand_d]
        chosen_cols = [cand_ids[:, 0]]
        seeds = cand_ids
        for i in range(1, ortho_count):
            # dedup the chosen list like the reference's new_cur
            # (src/antitopo_engine.h:407-413)
            valid_cols = [jnp.ones((W,), bool)]
            for jj in range(1, i):
                dupj = jnp.zeros((W,), bool)
                for kk in range(jj):
                    dupj = dupj | (chosen_cols[jj] == chosen_cols[kk])
                valid_cols.append(~dupj)
            ids_i, d_i, _ = beam_search(
                vectors, norms, adj, wq, wqn, seeds,
                ef=ef_c, max_iters=max_iters, sentinel=sentinel,
                precision=precision, expand=expand,
                ortho_chosen=jnp.stack(chosen_cols, axis=1),
                ortho_valid=jnp.stack(valid_cols, axis=1),
                ortho_factor=ortho_factor, ortho_bias=ortho_bias,
            )
            all_ids.append(ids_i)
            all_d.append(d_i)
            chosen_cols.append(ids_i[:, 0])
            seeds = ids_i
        u_ids = jnp.concatenate(all_ids, axis=1)
        u_d = jnp.concatenate(all_d, axis=1)
        # union keeping each id's best score: group by id, mask repeats
        u_ids, u_d = jax.lax.sort((u_ids, u_d), num_keys=2)
        rep = jnp.concatenate(
            [jnp.zeros((W, 1), bool), u_ids[:, 1:] == u_ids[:, :-1]], axis=1
        )
        u_d = jnp.where(rep, INF, u_d)
        u_ids = jnp.where(rep, sentinel, u_ids)
        cand_d, cand_ids = jax.lax.sort((u_d, u_ids), num_keys=2)

    cand_ids = cand_ids[:, :C]
    cand_d = cand_d[:, :C]

    cvecs = vectors[cand_ids]
    cnorms = jnp.where(jnp.isfinite(cand_d), norms[cand_ids], INF)
    co = pairwise_co_dist(cvecs, cnorms, precision)
    sel_ids, sel_d = antitopo_prune(
        cand_ids, cand_d, co,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=sentinel,
    )

    adj, counts = _write_forward(adj, counts, wave_ids, sel_ids, cap, sentinel)
    adj, counts = _reverse_append(adj, counts, wave_ids, sel_ids, sel_d, sentinel)

    # deferred lazy prune: handle the `overflow_rows` fullest destinations
    top_counts, rows = jax.lax.top_k(counts[:sentinel], overflow_rows)
    rows = jnp.where(top_counts > cap, rows, sentinel)
    adj, counts = _overflow_prune(
        vectors, norms, adj, counts, rows,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=sentinel, precision=precision,
    )
    return adj, counts


@functools.partial(
    jax.jit,
    donate_argnums=(2, 3),
    static_argnames=("cap", "prune_overflow", "precision"),
)
def _overflow_prune_jit(
    vectors, norms, adj, counts, rows,
    cap: int, ortho_factor, ortho_bias, prune_overflow: int,
    sentinel: int, precision: str,
):
    return _overflow_prune(
        vectors, norms, adj, counts, rows,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=sentinel, precision=precision,
    )


def build_index_wave(
    x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
    wave_size: int = 1024,
    bootstrap: int = 2048,
    slack: int = 64,
    verbose: bool = False,
) -> GraphIndex:
    """Incremental wave-batched build; drop-in alternative to build_index
    for corpora too large for O(N^2) candidate generation."""
    cfg = cfg or BuildConfig()
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    assert n > 0
    vectors, norms = make_corpus(x)
    sentinel = n
    cap = cfg.M0
    R = _round_up(cap + slack, 16)
    C = min(cfg.prune_cand, cfg.ef_construction)

    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)

    n0 = min(n, max(bootstrap, 2 * cap))
    adj = jnp.full((n + 1, R), sentinel, jnp.int32)
    counts = jnp.zeros((n + 1,), jnp.int32)

    # ---- bootstrap prefix: exact one-shot bottom layer (device array;
    # local sentinel n0 -> global sentinel n) ----
    boot = _build_layer(vectors[:n0], norms[:n0], cap=cap, cfg=cfg)
    bootR = boot.shape[1]
    boot_rows = jnp.full((n0, R), sentinel, jnp.int32)
    boot_rows = boot_rows.at[:, :bootR].set(
        jnp.where(boot == n0, sentinel, boot)
    )
    adj = adj.at[:n0].set(boot_rows)
    counts = counts.at[:n0].set(jnp.sum(boot_rows != sentinel, axis=1))

    # build entry point: medoid of the bootstrap block
    mean = jnp.mean(vectors[:n0], axis=0, keepdims=True)
    medoid = jnp.argmin(
        _gather_dist2(
            vectors, norms,
            jnp.arange(n0, dtype=jnp.int32)[None, :],
            mean, squared_norms(mean), cfg.precision,
        )[0]
    ).astype(jnp.int32)

    ef_c = cfg.ef_construction
    max_iters = 4 * ef_c + 32

    # ---- waves: one fused dispatch each ----
    i = n0
    wave_idx = 0
    while i < n:
        W = min(wave_size, n - i)
        ids_np = np.arange(i, i + W, dtype=np.int32)
        if W < wave_size and i > n0:
            ids_np = np.concatenate(
                [ids_np, np.full(wave_size - W, sentinel, np.int32)]
            )
        adj, counts = _wave_step(
            vectors, norms, adj, counts, jnp.asarray(ids_np), medoid,
            cap=cap, C=C, ef_c=ef_c, max_iters=max_iters,
            ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            overflow_rows=cfg.wave_overflow_rows, precision=cfg.precision,
            expand=cfg.wave_expand,
            sentinel=sentinel, ortho_count=cfg.ortho_count,
        )
        # one wave in flight at a time: the host waits for each wave
        # before dispatching the next (whether overlapping waves pays is
        # an open A/B, ROADMAP speed queue)
        jax.block_until_ready(counts)
        if verbose and wave_idx % 32 == 0:
            print(f"wave build: {i}/{n}", flush=True)
        i += W
        wave_idx += 1

    # final sweep so every row obeys the cap, then compact the width
    counts_np = np.asarray(counts[:n])
    over = np.nonzero(counts_np > cap)[0].astype(np.int32)
    if verbose:
        print(f"wave build: final overflow sweep ({over.size} rows)",
              flush=True)
    P = 128
    for r0 in range(0, over.size, P):
        rows = over[r0 : r0 + P]
        if rows.size < P:
            rows = np.concatenate(
                [rows, np.full(P - rows.size, sentinel, np.int32)]
            )
        adj, counts = _overflow_prune_jit(
            vectors, norms, adj, counts, jnp.asarray(rows),
            cap=cap, ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            sentinel=sentinel, precision=cfg.precision,
        )
        jax.block_until_ready(counts)  # one dispatch in flight (see above)

    R0 = _round_up(cap, 16)
    # slice on device: no host round-trip of the full (n+1, R) adjacency
    adj_bottom = adj[:, :R0]

    if verbose:
        print("wave build: upper layers", flush=True)
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    # query entry: the top-layer member (reference raises starting_vertex
    # as layers appear, src/antitopo_engine.h:459-462); fall back to the
    # build medoid for flat graphs
    if upper:
        members = np.nonzero(levels >= max_layer - 1)[0]
        sv = int(members[0]) if members.size else int(medoid)
    else:
        sv = int(medoid)

    jax.block_until_ready(adj_bottom)
    for u in upper:
        jax.block_until_ready(u.adj)

    return GraphIndex(
        vectors=vectors,
        norms=norms,
        adj_bottom=adj_bottom,
        layers=upper,
        starting_vertex=jnp.int32(sv),
    )

def extend_index_wave(
    graph: GraphIndex,
    new_x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
    wave_size: int = 1024,
    slack: int = 64,
    verbose: bool = False,
) -> GraphIndex:
    """Extend a built index with new vectors (store -> build -> store ->
    build accumulates, like the reference's insert-at-a-time construction:
    every ``store_vector`` call inserts into the live graph,
    src/antitopo_engine.h:310-330, so a second build round simply continues
    from the existing index).  Batched equivalent: continue wave-batched
    inserts over the existing bottom layer, then rebuild the (tiny) upper
    hierarchy over the combined corpus.

    Layer draws stay consistent with a from-scratch build of the combined
    corpus: ``draw_levels`` consumes one uniform per node from a seeded
    counter-based PRNG, so the first ``n_old`` draws of the extended run
    are bit-identical to the original build's.

    Quantized codes are intentionally dropped — the engine recomputes
    them on demand (models/antitopo.py ``_attach_codes``).
    """
    cfg = cfg or BuildConfig()
    new_x = np.asarray(new_x, np.float32)
    assert new_x.ndim == 2 and new_x.shape[0] > 0
    n_old = graph.n
    n = n_old + new_x.shape[0]
    sentinel = n
    cap = cfg.M0
    R = _round_up(cap + slack, 16)

    # combined corpus: old rows are already lane-padded; make_corpus pads
    # the concatenation (a no-op on the old block) and appends the fresh
    # +inf-norm sentinel row
    old_rows = np.asarray(graph.vectors[:n_old])
    d_pad = old_rows.shape[1]
    from expann_tpu.ops.distance import LANE, pad_dim

    new_rows = pad_dim(new_x, LANE)
    assert new_rows.shape[1] == d_pad, (
        f"dim mismatch: index built at padded dim {d_pad}, "
        f"new vectors pad to {new_rows.shape[1]}"
    )
    vectors, norms = make_corpus(np.concatenate([old_rows, new_rows], axis=0))

    # widen + re-sentinel the existing adjacency (old sentinel was n_old)
    old_adj = np.asarray(graph.adj_bottom[:n_old])
    old_adj = np.where(old_adj == n_old, sentinel, old_adj).astype(np.int32)
    r_keep = min(old_adj.shape[1], R)
    adj_np = np.full((n + 1, R), sentinel, np.int32)
    adj_np[:n_old, :r_keep] = old_adj[:, :r_keep]
    adj = jnp.asarray(adj_np)
    counts = jnp.asarray((adj_np != sentinel).sum(axis=1).astype(np.int32))

    medoid = jnp.asarray(graph.starting_vertex).astype(jnp.int32)
    C = min(cfg.prune_cand, cfg.ef_construction)
    ef_c = cfg.ef_construction
    max_iters = 4 * ef_c + 32

    i = n_old
    wave_idx = 0
    while i < n:
        W = min(wave_size, n - i)
        ids_np = np.arange(i, i + W, dtype=np.int32)
        if W < wave_size and wave_idx > 0:
            ids_np = np.concatenate(
                [ids_np, np.full(wave_size - W, sentinel, np.int32)]
            )
        adj, counts = _wave_step(
            vectors, norms, adj, counts, jnp.asarray(ids_np), medoid,
            cap=cap, C=C, ef_c=ef_c, max_iters=max_iters,
            ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            overflow_rows=cfg.wave_overflow_rows, precision=cfg.precision,
            expand=cfg.wave_expand,
            sentinel=sentinel, ortho_count=cfg.ortho_count,
        )
        jax.block_until_ready(counts)  # sync every wave (see build loop)
        if verbose and wave_idx % 32 == 0:
            print(f"extend build: {i}/{n}", flush=True)
        i += W
        wave_idx += 1

    # cap sweep (reverse edges may have overfilled any row, old or new)
    counts_np = np.asarray(counts[:n])
    over = np.nonzero(counts_np > cap)[0].astype(np.int32)
    P = 128
    for r0 in range(0, over.size, P):
        rows = over[r0 : r0 + P]
        if rows.size < P:
            rows = np.concatenate(
                [rows, np.full(P - rows.size, sentinel, np.int32)]
            )
        adj, counts = _overflow_prune_jit(
            vectors, norms, adj, counts, jnp.asarray(rows),
            cap=cap, ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            sentinel=sentinel, precision=cfg.precision,
        )
        jax.block_until_ready(counts)  # sync every dispatch (see build loop)

    R0 = _round_up(cap, 16)
    adj_bottom = adj[:, :R0]  # device slice, no host round-trip

    # hierarchy over the combined corpus (prefix-stable draws, see above)
    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    jax.block_until_ready(adj_bottom)
    if upper:
        members = np.nonzero(levels >= max_layer - 1)[0]
        sv = int(members[0]) if members.size else int(graph.starting_vertex)
    else:
        sv = int(graph.starting_vertex)

    return GraphIndex(
        vectors=vectors,
        norms=norms,
        adj_bottom=adj_bottom,
        layers=upper,
        starting_vertex=jnp.int32(sv),
    )


@functools.partial(
    jax.jit,
    donate_argnums=(2, 3),
    static_argnames=(
        "cap", "C", "ef_c", "max_iters", "prune_overflow", "overflow_rows",
        "precision", "expand", "sentinel",
    ),
)
def _refine_step(
    vectors, norms, adj, counts, wave_ids, medoid,
    cap: int, C: int, ef_c: int, max_iters: int,
    ortho_factor, ortho_bias, prune_overflow: int,
    overflow_rows: int, precision: str, expand: int, sentinel: int,
):
    """One fused refinement wave: re-derive a block of EXISTING nodes'
    out-edges against the FINAL graph (two-pass Vamana style).

    The wave builder's early nodes chose their edges against a small
    prefix of the corpus; this pass re-runs their insert search on the finished
    graph — same candidate semantics as the reference's construction
    search + prune (src/antitopo_engine.h:396-455) — and REPLACES each
    node's row with the fresh selection.  Three deltas vs `_wave_step`:

      * the beam is seeded with the node's CURRENT row (it starts near
        convergence, so refinement waves are cheaper than build waves),
      * the node's current edges join the candidate union with exact
        distances (a refined row is never worse than the prune of
        old ∪ new),
      * the node itself is masked out of the union (a node must not
        select itself; d=0 would otherwise win every prune).

    Reverse edges append with the same edge_exists dedup + deferred
    overflow prune as build waves.  Single dispatch; buffers donated.
    """
    safe = jnp.minimum(wave_ids, sentinel)
    wq = vectors[safe]
    wqn = norms[safe]
    W = wave_ids.shape[0]

    row = adj[safe]  # (W, R) current edges, sentinel-padded
    seeds = jnp.concatenate(
        [row, jnp.broadcast_to(medoid, (W,)).astype(jnp.int32)[:, None]],
        axis=1,
    )
    cand_ids, cand_d, _ = beam_search(
        vectors, norms, adj, wq, wqn, seeds,
        ef=ef_c, max_iters=max_iters, sentinel=sentinel,
        precision=precision, expand=expand,
    )

    # union: beam results + current row (exact distances), self masked
    row_d = _gather_dist2(vectors, norms, row, wq, wqn, precision)
    u_ids = jnp.concatenate([cand_ids, row], axis=1)
    u_d = jnp.concatenate([cand_d, row_d], axis=1)
    drop = (u_ids == wave_ids[:, None]) | (u_ids >= sentinel)
    u_d = jnp.where(drop, INF, u_d)
    u_ids = jnp.where(drop, sentinel, u_ids)
    # dedup by id keeping the best score, then rank by (d, id)
    u_ids, u_d = jax.lax.sort((u_ids, u_d), num_keys=2)
    rep = jnp.concatenate(
        [jnp.zeros((W, 1), bool), u_ids[:, 1:] == u_ids[:, :-1]], axis=1
    )
    u_d = jnp.where(rep, INF, u_d)
    u_ids = jnp.where(rep, sentinel, u_ids)
    cand_d, cand_ids = jax.lax.sort((u_d, u_ids), num_keys=2)
    cand_ids = cand_ids[:, :C]
    cand_d = cand_d[:, :C]

    cvecs = vectors[cand_ids]
    cnorms = jnp.where(jnp.isfinite(cand_d), norms[cand_ids], INF)
    co = pairwise_co_dist(cvecs, cnorms, precision)
    sel_ids, sel_d = antitopo_prune(
        cand_ids, cand_d, co,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=sentinel,
    )

    adj, counts = _write_forward(adj, counts, wave_ids, sel_ids, cap, sentinel)
    adj, counts = _reverse_append(adj, counts, wave_ids, sel_ids, sel_d, sentinel)

    top_counts, rows = jax.lax.top_k(counts[:sentinel], overflow_rows)
    rows = jnp.where(top_counts > cap, rows, sentinel)
    adj, counts = _overflow_prune(
        vectors, norms, adj, counts, rows,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, sentinel=sentinel, precision=precision,
    )
    return adj, counts


def refine_index_wave(
    graph: GraphIndex,
    cfg: Optional[BuildConfig] = None,
    frac: float = 0.5,
    wave_size: int = 4096,
    refine_ef: int = 0,
    slack: int = 64,
    verbose: bool = False,
) -> GraphIndex:
    """Second-pass refinement of a wave-built index.

    Re-inserts the FIRST ``frac`` of the corpus — the nodes that built
    against the smallest prefixes — against the final graph via
    `_refine_step`, then rebuilds the (tiny) upper hierarchy.  ``refine_ef``
    defaults to ``cfg.ef_construction``.  Derived serving caches are
    dropped (recomputed on demand), like `extend_index_wave`.
    """
    cfg = cfg or BuildConfig()
    vectors, norms = graph.vectors, graph.norms
    n = graph.n
    sentinel = n
    cap = cfg.M0
    R = _round_up(cap + slack, 16)
    ef_c = refine_ef or cfg.ef_construction
    C = min(cfg.prune_cand or ef_c, ef_c)

    # working buffers: pad the served adjacency back out to the slack width
    R0 = graph.adj_bottom.shape[1]
    adj = jnp.concatenate(
        [
            graph.adj_bottom,
            jnp.full((n + 1, R - R0), sentinel, jnp.int32),
        ],
        axis=1,
    ) if R > R0 else graph.adj_bottom[:, :R]
    counts = jnp.sum(adj != sentinel, axis=1).astype(jnp.int32)

    medoid = jnp.asarray(graph.starting_vertex, jnp.int32)
    n_refine = int(n * frac)
    max_iters = 4 * ef_c + 32  # same convergence bound as build waves

    idx = 0
    wave = 0
    total_waves = (n_refine + wave_size - 1) // wave_size
    while idx < n_refine:
        end = min(idx + wave_size, n_refine)
        ids = np.arange(idx, end, dtype=np.int32)
        if ids.size < wave_size:
            ids = np.concatenate(
                [ids, np.full(wave_size - ids.size, sentinel, np.int32)]
            )
        adj, counts = _refine_step(
            vectors, norms, adj, counts, jnp.asarray(ids), medoid,
            cap=cap, C=C, ef_c=ef_c, max_iters=max_iters,
            ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            overflow_rows=cfg.wave_overflow_rows, precision=cfg.precision,
            expand=cfg.wave_expand, sentinel=sentinel,
        )
        jax.block_until_ready(counts)  # sync every wave (see build loop)
        if verbose and wave % 32 == 0:
            print(f"refine wave {wave}/{total_waves}", flush=True)
        idx = end
        wave += 1

    # final sweep over any still-overflowing rows, then slice to serve width
    P = 1024
    while True:
        c_host = np.asarray(counts[:sentinel])
        over = np.nonzero(c_host > cap)[0].astype(np.int32)
        if over.size == 0:
            break
        rows = over[:P]
        if rows.size < P:
            rows = np.concatenate(
                [rows, np.full(P - rows.size, sentinel, np.int32)]
            )
        adj, counts = _overflow_prune_jit(
            vectors, norms, adj, counts, jnp.asarray(rows),
            cap=cap, ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
            prune_overflow=cfg.prune_overflow,
            sentinel=sentinel, precision=cfg.precision,
        )

    R_serve = _round_up(cap, 16)
    adj_bottom = adj[:, :R_serve]

    levels, max_layer, _ = draw_levels(n, cfg.M, cfg.seed)
    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)
    jax.block_until_ready(adj_bottom)
    if upper:
        members = np.nonzero(levels >= max_layer - 1)[0]
        sv = int(members[0]) if members.size else int(graph.starting_vertex)
    else:
        sv = int(graph.starting_vertex)

    return GraphIndex(
        vectors=vectors,
        norms=norms,
        adj_bottom=adj_bottom,
        layers=upper,
        starting_vertex=jnp.int32(sv),
    )
