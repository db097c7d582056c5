"""Batched one-shot index construction.

The reference builds its HNSW-variant graph by inserting one vector at a
time: a beam search over the already-built prefix produces an
ef_construction-wide candidate list, the anti-topo prune selects edges, and
reverse edges are appended with lazy pruning
(reference: src/antitopo_engine.h:310-465 ``_store_vector``).  That loop is
inherently sequential — the accelerator answer is to restructure it as
dense batched passes (SURVEY.md section 7 step 4, "hard parts" item 2; the
acceptance test is recall/QPS parity, not graph isomorphism):

  1. draw every node's HNSW layer up front (same geometric law,
     floor(-ln U / ln M), src/antitopo_engine.h:323) — layer membership,
     max_layer and the starting vertex are then known in advance,
  2. per layer, generate candidates by *exact* batched k-NN among the
     layer's members — one jitted scan of (row_block x col_block) matmul tiles
     with a running top-C merge, entirely device-resident (a strictly
     better candidate set than the reference's approximate beam search),
  3. run the batched anti-topo prune (models/prune.py) over all members as
     one ``lax.map`` over node chunks (one dispatch, bounded memory),
  4. a single reverse pass adds back-edges (skipping ones already present,
     mirroring the edge_exists check at src/antitopo_engine.h:442-450):
     nodes that stay within the edge cap keep append order (the lazy branch
     of prune_edges, :270-273), overflowing nodes are re-pruned over the
     union of their forward and incoming edges.

Controlled divergence (reverse-pass cap): incoming edges per destination
are collected into a fixed-width buffer of A = min(2*cap, 4096) slots; a
hub node receiving more than A incoming edges silently drops the excess in
source-chunk order (nearest-first *within* each 8192-row chunk, since
chunks are sorted by (dst, d) before the scatter), whereas the reference
re-prunes the full union on every overflow (src/antitopo_engine.h:441-455).
A distance-sorted global selection would need per-chunk row sorts over the
whole corpus — a sort of the whole corpus per chunk — and with cap = M0 = 120 the final prune still selects from 2*cap = 240
candidates, 2x the reference's own working set; end-recall parity tests
gate the approximation.

Everything between host entry and the final adjacency download runs in a
handful of device dispatches.  This build is O(n_l^2) distance work per
layer; ``builder="auto"`` sends corpora above ``auto_wave_threshold`` rows
to the distributed builder (parallel/distbuild.py) instead.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from expann_tpu.models.graph import GraphIndex, UpperLayer, make_corpus
from expann_tpu.models.prune import antitopo_prune, pairwise_co_dist
from expann_tpu.ops.distance import pairwise_dist2

INF = jnp.inf


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def draw_levels(n: int, M: int, seed: int = 0) -> Tuple[np.ndarray, int, int]:
    """Per-node geometric layer draws + resulting max_layer/starting_vertex.

    Same law as the reference (floor(-ln U / ln M),
    src/antitopo_engine.h:323) with a seeded counter-based PRNG instead of
    mt19937(0); starting_vertex tracking replays the sequential update rule
    (src/antitopo_engine.h:459-462): each node whose drawn level reaches the
    current max raises it and becomes the entry point.
    """
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    u = np.clip(u, 1e-300, 1.0 - 1e-16)
    levels = np.floor(-np.log(u) / math.log(M)).astype(np.int32)
    max_layer = 0
    sv = 0
    for i in range(n):
        while levels[i] >= max_layer:
            max_layer += 1
            sv = i
    return levels, max_layer, sv


@functools.partial(
    jax.jit, static_argnames=("C", "row_block", "col_block", "precision")
)
def exact_knn_device(
    vecs: jax.Array,  # (n_pad, D), rows padded with +inf-norm sentinels
    norms: jax.Array,  # (n_pad,)
    C: int,
    row_block: int,
    col_block: int,
    precision: str,
) -> Tuple[jax.Array, jax.Array]:
    """Exact C-nearest-neighbours of every row against all rows (self
    excluded), as ONE device program: a scan over row blocks, each running
    a fori over column blocks of matmul + top-C + sorted merge.

    ``n_pad`` must be a multiple of both row_block and col_block; padding
    rows carry +inf norms so they never rank.  Ties break by ascending id
    (lexicographic (d, id)), matching the reference's std::set ordering.
    Returns device arrays ``(ids, d)`` of shape ``(n_pad, C)``.
    """
    n_pad, D = vecs.shape
    n_row_chunks = n_pad // row_block
    n_col_chunks = n_pad // col_block

    q_chunks = vecs.reshape(n_row_chunks, row_block, D)
    qn_chunks = norms.reshape(n_row_chunks, row_block)
    row_ids = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_row_chunks, row_block)

    kk = min(C, col_block)

    def row_step(_, chunk):
        qv, qn, rids = chunk
        run_d = jnp.full((row_block, C), INF, jnp.float32)
        run_i = jnp.full((row_block, C), n_pad, jnp.int32)

        def col_step(c, carry):
            run_d, run_i = carry
            xv = jax.lax.dynamic_slice(
                vecs, (c * col_block, 0), (col_block, D)
            )
            xn = jax.lax.dynamic_slice(norms, (c * col_block,), (col_block,))
            d2 = pairwise_dist2(qv, xv, x_norms=xn, q_norms=qn, precision=precision)
            col_ids = c * col_block + jax.lax.broadcasted_iota(
                jnp.int32, (1, col_block), 1
            )
            d2 = jnp.where(col_ids == rids[:, None], INF, d2)
            neg_d, idx = jax.lax.top_k(-d2, kk)
            blk_d = -neg_d
            blk_i = jnp.take_along_axis(
                jnp.broadcast_to(col_ids, d2.shape), idx, axis=1
            )
            all_d = jnp.concatenate([run_d, blk_d], axis=1)
            all_i = jnp.concatenate([run_i, blk_i], axis=1)
            all_d, all_i = jax.lax.sort((all_d, all_i), num_keys=2)
            return all_d[:, :C], all_i[:, :C]

        run_d, run_i = jax.lax.fori_loop(0, n_col_chunks, col_step, (run_d, run_i))
        return None, (run_d, run_i)

    _, (d_out, i_out) = jax.lax.scan(
        row_step, None, (q_chunks, qn_chunks, row_ids)
    )
    return i_out.reshape(n_pad, C), d_out.reshape(n_pad, C)


@functools.partial(
    jax.jit, static_argnames=("C", "row_block", "col_block", "precision")
)
def ortho_knn_device(
    vecs: jax.Array,  # (n_pad, D) rows padded with +inf-norm sentinels
    norms: jax.Array,  # (n_pad,)
    chosen: jax.Array,  # (n_pad, OC) ids of previously chosen entry points
    chosen_valid: jax.Array,  # (n_pad, OC) bool
    ortho_factor,
    ortho_bias,
    C: int,
    row_block: int,
    col_block: int,
    precision: str,
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-C by the *ortho-penalized* score, streamed like
    exact_knn_device.  Score per candidate c of node q (reference:
    src/antitopo_engine.h:342-351):

        score(c) = d2(q, c) + sum over chosen p of
                   [d2(p, c) < d2(q, c)] * (ortho_factor * (d2(q,c) - d2(p,c))
                                            + ortho_bias)

    This is the dense-exact version of the reference's i-th ortho-penalized
    construction search; each chosen point costs one extra matmul per tile.
    Returns (ids, score) sorted by (score, id) — like the reference, the
    carried value is the penalized score, which then feeds the prune's
    basic_dist (src/antitopo_engine.h:415-423,281-283).
    """
    n_pad, D = vecs.shape
    OC = chosen.shape[1]
    n_row_chunks = n_pad // row_block
    n_col_chunks = n_pad // col_block

    q_chunks = vecs.reshape(n_row_chunks, row_block, D)
    qn_chunks = norms.reshape(n_row_chunks, row_block)
    row_ids = jnp.arange(n_pad, dtype=jnp.int32).reshape(n_row_chunks, row_block)
    ch_chunks = chosen.reshape(n_row_chunks, row_block, OC)
    chv_chunks = chosen_valid.reshape(n_row_chunks, row_block, OC)

    kk = min(C, col_block)

    def row_step(_, chunk):
        qv, qn, rids, ch, chv = chunk
        # gather the chosen entry-point vectors for this row block
        pv = vecs[jnp.minimum(ch, n_pad - 1)]  # (rb, OC, D)
        pn = norms[jnp.minimum(ch, n_pad - 1)]  # (rb, OC)
        run_d = jnp.full((row_block, C), INF, jnp.float32)
        run_i = jnp.full((row_block, C), n_pad, jnp.int32)

        def col_step(c, carry):
            run_d, run_i = carry
            xv = jax.lax.dynamic_slice(vecs, (c * col_block, 0), (col_block, D))
            xn = jax.lax.dynamic_slice(norms, (c * col_block,), (col_block,))
            d2 = pairwise_dist2(qv, xv, x_norms=xn, q_norms=qn, precision=precision)
            # co-distances of each chosen point to every candidate
            co_dots = jnp.einsum(
                "rod,cd->roc", pv, xv,
                preferred_element_type=jnp.float32, precision=precision,
            )  # (rb, OC, cb)
            co = pn[:, :, None] + xn[None, None, :] - 2.0 * co_dots
            hit = (co < d2[:, None, :]) & chv[:, :, None]
            pen = jnp.where(
                hit, ortho_factor * (d2[:, None, :] - co) + ortho_bias, 0.0
            )
            score = d2 + jnp.sum(pen, axis=1)
            col_ids = c * col_block + jax.lax.broadcasted_iota(
                jnp.int32, (1, col_block), 1
            )
            score = jnp.where(col_ids == rids[:, None], INF, score)
            neg_s, idx = jax.lax.top_k(-score, kk)
            blk_s = -neg_s
            blk_i = jnp.take_along_axis(
                jnp.broadcast_to(col_ids, score.shape), idx, axis=1
            )
            all_s = jnp.concatenate([run_d, blk_s], axis=1)
            all_i = jnp.concatenate([run_i, blk_i], axis=1)
            all_s, all_i = jax.lax.sort((all_s, all_i), num_keys=2)
            return all_s[:, :C], all_i[:, :C]

        run_d, run_i = jax.lax.fori_loop(0, n_col_chunks, col_step, (run_d, run_i))
        return None, (run_d, run_i)

    _, (d_out, i_out) = jax.lax.scan(
        row_step, None, (q_chunks, qn_chunks, row_ids, ch_chunks, chv_chunks)
    )
    return i_out.reshape(n_pad, C), d_out.reshape(n_pad, C)


@functools.partial(
    jax.jit,
    static_argnames=("cap", "prune_overflow", "prune_block", "precision"),
)
def prune_all_device(
    vec_s: jax.Array,  # (n_pad + 1, D) corpus with sentinel row
    norm_s: jax.Array,
    cand_ids: jax.Array,  # (n_pad, C) sorted by (d, id)
    cand_d: jax.Array,
    cap: int,
    ortho_factor,
    ortho_bias,
    prune_overflow: int,
    prune_block: int,
    precision: str,
) -> Tuple[jax.Array, jax.Array]:
    """Anti-topo prune of every node's candidate list as one ``lax.map``
    over fixed-size node chunks (bounded co-distance memory, one dispatch)."""
    n_pad, C = cand_ids.shape
    sentinel = vec_s.shape[0] - 1
    n_chunks = n_pad // prune_block
    ids_c = cand_ids.reshape(n_chunks, prune_block, C)
    d_c = cand_d.reshape(n_chunks, prune_block, C)

    def body(chunk):
        cid, cd = chunk
        cid = jnp.minimum(cid, sentinel)
        cvec = vec_s[cid]
        cnorm = jnp.where(jnp.isfinite(cd), norm_s[cid], INF)
        co = pairwise_co_dist(cvec, cnorm, precision)
        return antitopo_prune(
            cid, cd, co,
            cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
            prune_overflow=prune_overflow, sentinel=sentinel,
        )

    sel_ids, sel_d = jax.lax.map(body, (ids_c, d_c))
    return sel_ids.reshape(n_pad, cap), sel_d.reshape(n_pad, cap)


@functools.partial(jax.jit, static_argnames=("A", "chunk_rows"))
def _incoming_edges(sel_ids, sel_d, A: int, sentinel: int, chunk_rows: int = 8192):
    """Group the forward edge list by destination: returns per-node incoming
    (src, d) lists of width A (the one-shot analogue of the reference's
    sequential reverse-edge appends, src/antitopo_engine.h:441-455).

    Runs as a scan over source-row chunks, each sorting ~chunk_rows*cap
    edges by (dst, d) and appending into the running incoming lists at
    position count[dst] — a single global sort of the whole N*cap edge list
    chokes the compiler, and chunk-sequential append order reproduces the
    reference's *insert-order* reverse appends anyway."""
    W, cap = sel_ids.shape
    W_pad = ((W + chunk_rows - 1) // chunk_rows) * chunk_rows
    pad = W_pad - W
    ids_p = jnp.pad(sel_ids, ((0, pad), (0, 0)), constant_values=sentinel)
    d_p = jnp.pad(sel_d, ((0, pad), (0, 0)), constant_values=INF)
    n_chunks = W_pad // chunk_rows
    ids_c = ids_p.reshape(n_chunks, chunk_rows, cap)
    d_c = d_p.reshape(n_chunks, chunk_rows, cap)
    offsets = (
        jnp.arange(n_chunks, dtype=jnp.int32) * chunk_rows
    )

    inc_src0 = jnp.full((W + 1, A), sentinel, jnp.int32)
    inc_d0 = jnp.full((W + 1, A), INF, jnp.float32)
    cnt0 = jnp.zeros((W + 1,), jnp.int32)

    def chunk_step(carry, chunk):
        inc_src, inc_d, cnt = carry
        s_ids, s_d, off = chunk
        src = off + jax.lax.broadcasted_iota(jnp.int32, (chunk_rows, cap), 0)
        src = src.reshape(-1)
        dst = jnp.minimum(s_ids.reshape(-1), sentinel)
        d = s_d.reshape(-1)
        dst = jnp.where(jnp.isfinite(d), dst, sentinel)
        dst_s, d_s, src_s = jax.lax.sort((dst, d, src), num_keys=3)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), dst_s[1:] != dst_s[:-1]]
        )
        idx = jnp.arange(dst_s.shape[0], dtype=jnp.int32)
        group_start = jax.lax.associative_scan(
            jnp.maximum, jnp.where(first, idx, 0)
        )
        pos = idx - group_start
        write_pos = cnt[dst_s] + pos
        ok = (dst_s != sentinel) & (write_pos < A)
        rows = jnp.where(ok, dst_s, W + 1)  # out of bounds -> dropped
        cols = jnp.minimum(write_pos, A - 1)
        inc_src = inc_src.at[rows, cols].set(src_s, mode="drop")
        inc_d = inc_d.at[rows, cols].set(d_s, mode="drop")
        cnt = cnt.at[rows].add(jnp.where(ok, 1, 0), mode="drop")
        return (inc_src, inc_d, cnt), None

    (inc_src, inc_d, _), _ = jax.lax.scan(
        chunk_step, (inc_src0, inc_d0, cnt0), (ids_c, d_c, offsets)
    )
    return inc_src[:W], inc_d[:W]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _merge_lazy(sel_ids, sel_d, inc_src, inc_d, chunk: int = 512):
    """Append incoming edges after forward edges (the reference's lazy
    prune branch keeps plain append order, src/antitopo_engine.h:270-273),
    dropping incoming edges already present in the forward list (the
    edge_exists check, :442-450).  Chunked so the (rows, A, cap) dup mask
    stays small.  Returns (ids, d, total_count)."""
    W = sel_ids.shape[0]
    sentinel_rows = W  # dup-marked entries also get d=INF, which governs

    def body(args):
        s_ids, s_d, i_src, i_d = args
        dup = (i_src[:, :, None] == s_ids[:, None, :]).any(-1)
        i_d = jnp.where(dup, INF, i_d)
        i_src = jnp.where(dup, sentinel_rows, i_src)
        ids = jnp.concatenate([s_ids, i_src], axis=1)
        d = jnp.concatenate([s_d, i_d], axis=1)
        count = jnp.sum(jnp.isfinite(d), axis=1)
        return ids, d, count

    if W <= chunk:
        return body((sel_ids, sel_d, inc_src, inc_d))
    W_pad = ((W + chunk - 1) // chunk) * chunk
    pad = W_pad - W

    def padded(a, fill):
        return jnp.pad(a, ((0, pad), (0, 0)), constant_values=fill)

    C2 = sel_ids.shape[1] + inc_src.shape[1]
    ids, d, count = jax.lax.map(
        body,
        (
            padded(sel_ids, sentinel_rows).reshape(-1, chunk, sel_ids.shape[1]),
            padded(sel_d, INF).reshape(-1, chunk, sel_d.shape[1]),
            padded(inc_src, sentinel_rows).reshape(-1, chunk, inc_src.shape[1]),
            padded(inc_d, INF).reshape(-1, chunk, inc_d.shape[1]),
        ),
    )
    return (
        ids.reshape(W_pad, C2)[:W],
        d.reshape(W_pad, C2)[:W],
        count.reshape(W_pad)[:W],
    )


@functools.partial(
    jax.jit,
    static_argnames=("cap", "R", "prune_overflow", "prune_block", "precision"),
)
def _finish_rows_device(
    vec_s: jax.Array,  # (n_pad + 1, D) corpus with sentinel row
    norm_s: jax.Array,
    merged_ids: jax.Array,  # (W, C2) forward ++ incoming, dups masked
    merged_d: jax.Array,  # (W, C2), +inf on invalid
    count: jax.Array,  # (W,) live edges per row
    cap: int,
    R: int,
    ortho_factor,
    ortho_bias,
    prune_overflow: int,
    prune_block: int,
    precision: str,
) -> jax.Array:
    """Finish the reverse pass entirely on device: rows within the cap keep
    append order (the reference's lazy branch, src/antitopo_engine.h:270-273),
    overflowing rows are re-pruned over their (d, id)-sorted union
    (:441-455).  Keeps the merged edge lists on the device (no host
    round-trip); the prune runs for *all* rows and a per-row select keeps
    the correct branch.  Returns the
    final ``(W, R)`` adjacency, sentinel-padded."""
    W, C2 = merged_ids.shape
    sentinel = vec_s.shape[0] - 1
    ids_min = jnp.minimum(merged_ids, sentinel)

    # ---- lazy branch: stable left-pack of valid entries, append order ----
    invalid = (~jnp.isfinite(merged_d)).astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (W, C2), 1)
    inv_s, _, ids_s = jax.lax.sort((invalid, pos, ids_min), num_keys=2)
    lazy = jnp.where(inv_s == 1, sentinel, ids_s)
    if C2 < R:
        lazy = jnp.pad(lazy, ((0, 0), (0, R - C2)), constant_values=sentinel)
    lazy = lazy[:, :R]

    # ---- overflow branch: (d, id)-sorted union, full anti-topo prune ----
    d_u, i_u = jax.lax.sort((merged_d, ids_min), num_keys=2)
    over_ids, _ = prune_all_device(
        vec_s, norm_s, i_u, d_u,
        cap=cap, ortho_factor=ortho_factor, ortho_bias=ortho_bias,
        prune_overflow=prune_overflow, prune_block=prune_block,
        precision=precision,
    )
    over = jnp.pad(
        over_ids, ((0, 0), (0, R - cap)), constant_values=sentinel
    )[:, :R]

    return jnp.where((count <= cap)[:, None], lazy, over)


@dataclasses.dataclass
class BuildConfig:
    M: int = 60
    M0: int = 0  # 0 -> 2 * M (reference constructor default)
    ef_construction: int = 500
    ortho_count: int = 1
    ortho_factor: float = 0.5
    ortho_bias: float = 0.0
    prune_overflow: int = 0
    prune_cand: int = 0  # 0 -> min(ef_construction, 256)
    seed: int = 0
    precision: str = "highest"
    row_block: int = 2048
    col_block: int = 8192
    prune_block: int = 256
    # builder selection: "oneshot" (exact O(N^2) candidates), "wave"
    # (incremental wave inserts, models/wavebuild.py), or "auto"
    builder: str = "auto"
    wave_size: int = 1024
    auto_wave_threshold: int = 131072
    # wave-builder knobs (models/wavebuild._wave_step): beam expansion rows
    # per iteration, and how many of the fullest destinations get the
    # deferred lazy prune each wave
    wave_expand: int = 4
    wave_overflow_rows: int = 128
    # two-pass refinement (models/wavebuild.refine_index_wave): re-insert
    # the first `refine_frac` of the corpus against the final graph after
    # a wave build (0 disables)
    refine_frac: float = 0.0

    def __post_init__(self):
        if self.M0 == 0:
            self.M0 = 2 * self.M
        if self.prune_cand == 0:
            self.prune_cand = min(self.ef_construction, 256)


def _build_layer(
    member_vecs: jax.Array,
    member_norms: jax.Array,
    cap: int,
    cfg: BuildConfig,
) -> np.ndarray:
    """Build one layer's adjacency over its member set.

    All ids here are layer-local slots; sentinel is n_l.  Returns a *device*
    ``(n_l, R)`` int32 array (R = cap rounded up to 16) in final edge order —
    nothing round-trips to the host.
    """
    n = member_vecs.shape[0]
    sentinel = n
    C = min(cfg.prune_cand, max(n - 1, 1))

    # pad rows/cols to block multiples with +inf-norm sentinel rows so the
    # kNN scan is one fixed-shape device program; block sizes are chosen so
    # both divide the padded size (cfg blocks are powers of two)
    if n <= cfg.row_block:
        n_pad = _round_up(n, 8)
        row_block = col_block = n_pad
    elif n <= cfg.col_block:
        n_pad = _round_up(n, cfg.row_block)
        row_block = cfg.row_block
        col_block = n_pad
    else:
        n_pad = _round_up(n, cfg.col_block)
        row_block = cfg.row_block
        col_block = cfg.col_block
    pad = n_pad - n
    vecs_p = jnp.concatenate(
        [member_vecs, jnp.zeros((pad, member_vecs.shape[1]), jnp.float32)], 0
    )
    norms_p = jnp.concatenate(
        [member_norms, jnp.full((pad,), INF, jnp.float32)], 0
    )
    knn_ids, knn_d = exact_knn_device(
        vecs_p, norms_p, C=C, row_block=row_block, col_block=col_block,
        precision=cfg.precision,
    )

    if cfg.ortho_count > 1:
        # Reference construction runs ortho_count searches per insert and
        # unions their result lists (src/antitopo_engine.h:396-423): search
        # i penalizes candidates that are closer to the previously chosen
        # entry points than to the new vertex.  Dense-exact version: pass 0
        # is the plain kNN above; each later pass is an exact penalized
        # scan (ortho_knn_device) against the i best-so-far entry points
        # (the reference's new_cur, deduplicated, :407-413); the union
        # keeps each id's best score — like the reference, carried values
        # of penalized passes are the penalized scores.
        all_ids = [knn_ids]
        all_d = [knn_d]
        chosen_cols = [knn_ids[:, 0]]
        for i in range(1, cfg.ortho_count):
            chosen = jnp.stack(chosen_cols, axis=1)  # (n_pad, i)
            valid_cols = [jnp.ones_like(chosen_cols[0], dtype=bool)]
            for jj in range(1, i):
                dupj = jnp.zeros_like(valid_cols[0])
                for kk2 in range(jj):
                    dupj = dupj | (chosen_cols[jj] == chosen_cols[kk2])
                valid_cols.append(~dupj)
            chosen_valid = jnp.stack(valid_cols, axis=1)
            ids_i, d_i = ortho_knn_device(
                vecs_p, norms_p, chosen, chosen_valid,
                cfg.ortho_factor, cfg.ortho_bias,
                C=C, row_block=row_block, col_block=col_block,
                precision=cfg.precision,
            )
            all_ids.append(ids_i)
            all_d.append(d_i)
            chosen_cols.append(ids_i[:, 0])
        cat_d = jnp.concatenate(all_d, axis=1)
        cat_i = jnp.concatenate(all_ids, axis=1)
        # dedup by id keeping the best score: sort by (id, score), mask
        # repeats, sort back by (score, id), truncate to C
        i_s, d_s = jax.lax.sort((cat_i, cat_d), num_keys=2)
        first = jnp.concatenate(
            [jnp.ones((n_pad, 1), bool), i_s[:, 1:] != i_s[:, :-1]], axis=1
        )
        d_s = jnp.where(first, d_s, INF)
        i_s = jnp.where(first, i_s, n_pad)
        knn_d, knn_ids = jax.lax.sort((d_s, i_s), num_keys=2)
        knn_d = knn_d[:, :C]
        knn_ids = knn_ids[:, :C]

    # Corpus with sentinel row for gathers during prune (padded ids >= n all
    # collapse onto the sentinel row).
    vec_s = jnp.concatenate(
        [member_vecs, jnp.zeros((1, member_vecs.shape[1]), jnp.float32)], 0
    )
    norm_s = jnp.concatenate([member_norms, jnp.array([INF], jnp.float32)], 0)

    # --- forward prune (one dispatch) ---
    pb = min(cfg.prune_block, n_pad)
    while n_pad % pb != 0:
        pb //= 2
    sel_ids_j, sel_d_j = prune_all_device(
        vec_s, norm_s,
        jnp.minimum(knn_ids, sentinel), knn_d,
        cap=cap, ortho_factor=cfg.ortho_factor, ortho_bias=cfg.ortho_bias,
        prune_overflow=cfg.prune_overflow, prune_block=pb,
        precision=cfg.precision,
    )

    # --- reverse pass (device-resident end to end; padding rows carry only
    # +inf candidates so they contribute no edges and their final rows are
    # sliced off) ---
    A = min(2 * cap, 4096)
    inc_src, inc_d = _incoming_edges(sel_ids_j, sel_d_j, A=A, sentinel=sentinel)
    merged_ids_j, merged_d_j, count_j = _merge_lazy(
        sel_ids_j, sel_d_j, inc_src, inc_d
    )
    R = _round_up(cap, 16)
    adj = _finish_rows_device(
        vec_s, norm_s, merged_ids_j, merged_d_j, count_j,
        cap=cap, R=R, ortho_factor=cfg.ortho_factor,
        ortho_bias=cfg.ortho_bias, prune_overflow=cfg.prune_overflow,
        prune_block=pb, precision=cfg.precision,
    )
    return adj[:n]


def build_upper_layers(
    vectors: jax.Array,
    norms: jax.Array,
    levels: np.ndarray,
    max_layer: int,
    cfg: BuildConfig,
) -> Tuple[UpperLayer, ...]:
    """Build the compact upper HNSW layers (1 .. max_layer - 1) over the
    level-draw member sets.  Layer populations shrink geometrically
    (expected n / M^layer), so each is a small one-shot exact-kNN + prune."""
    n = vectors.shape[0] - 1
    sentinel = n
    upper: List[UpperLayer] = []
    for layer in range(1, max_layer):
        members = np.nonzero(levels >= layer)[0].astype(np.int32)
        n_l = members.size
        if n_l == 0:
            break
        members_j = jnp.asarray(members)
        mv = vectors[members_j]
        mn = norms[members_j]
        adj_local = _build_layer(mv, mn, cap=cfg.M, cfg=cfg)  # device
        Ru = adj_local.shape[1]
        # local slots -> global ids; local sentinel n_l -> global sentinel n
        lut = jnp.concatenate(
            [members_j, jnp.array([sentinel], jnp.int32)]
        )
        adj_global = jnp.concatenate(
            [
                lut[jnp.minimum(adj_local, n_l)],
                jnp.full((1, Ru), sentinel, jnp.int32),
            ],
            axis=0,
        )
        slot = np.full(n + 1, n_l, np.int32)
        slot[members] = np.arange(n_l, dtype=np.int32)
        upper.append(
            UpperLayer(slot=jnp.asarray(slot), adj=adj_global)
        )
    return tuple(upper)


def build_index(
    x: np.ndarray,
    cfg: Optional[BuildConfig] = None,
) -> GraphIndex:
    """Build a GraphIndex over corpus ``x`` (host ``(N, D)`` float array).

    Dispatches between the one-shot exact-candidate builder (below) and the
    incremental wave builder (models/wavebuild.py) per ``cfg.builder``.
    """
    cfg = cfg or BuildConfig()
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    assert n > 0

    if cfg.builder in ("wave", "dist") or (
        cfg.builder == "auto" and n > cfg.auto_wave_threshold
    ):
        # auto-scale the wave above the default: per-wave dispatch cost is
        # ~constant in W (it's prefix-scan bound), so a million-row corpus
        # at W=1024 pays ~1000 dispatches where W=4096 pays ~250 for the
        # same candidate quality.  An explicitly non-default wave_size is
        # honored.
        ws = cfg.wave_size
        if ws == 1024 and n >= 4 * cfg.auto_wave_threshold:
            ws = 4096
        # the env knob turns on per-32-wave progress lines (engine/CLI path
        # has no verbose parameter to thread through)
        import os as _os

        verbose = _os.environ.get("EXPANN_BUILD_VERBOSE") == "1"
        if cfg.builder == "wave":
            # explicit opt-in only: "auto" routes large corpora to the
            # distributed builder on a one-device mesh (incremental waves,
            # flat-scan candidates); whether the wave builder would serve
            # them better is an open A/B (ROADMAP)
            from expann_tpu.models.wavebuild import build_index_wave

            g = build_index_wave(x, cfg, wave_size=ws, verbose=verbose)
        else:
            from expann_tpu.parallel.distbuild import build_distributed
            from expann_tpu.parallel.sharded import make_mesh

            # incremental waves: one-shot whole-corpus candidates leave a
            # clustered corpus in disconnected components (parallel/
            # distbuild.py); candidates="auto": flat scans above 64k rows,
            # dense-exact below
            g, _stats = build_distributed(
                x, cfg, make_mesh(1), wave_size=max(ws, 4096),
                mode="incremental", candidates="auto", verbose=verbose,
            )
        if cfg.refine_frac > 0.0:
            from expann_tpu.models.wavebuild import refine_index_wave

            g = refine_index_wave(
                g, cfg, frac=cfg.refine_frac, wave_size=ws
            )
        return g

    vectors, norms = make_corpus(x)
    sentinel = n

    levels, max_layer, sv = draw_levels(n, cfg.M, cfg.seed)

    # ---- bottom layer over all nodes ----
    # bottom-layer local sentinel (= n) coincides with the global sentinel,
    # so the device rows are final as-is; append the all-sentinel dummy row
    adj0_local = _build_layer(vectors[:n], norms[:n], cap=cfg.M0, cfg=cfg)
    R0 = adj0_local.shape[1]
    adj_bottom = jnp.concatenate(
        [adj0_local, jnp.full((1, R0), sentinel, jnp.int32)], axis=0
    )

    upper = build_upper_layers(vectors, norms, levels, max_layer, cfg)

    # the build is device-resident end to end; block here so callers'
    # time_to_build_ns semantics match the reference (build returns a
    # FINISHED index, src/basic_bench.h:62-71) instead of an async handle
    jax.block_until_ready(adj_bottom)
    for u in upper:
        jax.block_until_ready(u.adj)

    return GraphIndex(
        vectors=vectors,
        norms=norms,
        adj_bottom=adj_bottom,
        layers=tuple(upper),
        starting_vertex=jnp.int32(sv),
    )
