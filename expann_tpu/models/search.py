"""Batched graph traversal: greedy upper-layer descent + bottom beam search.

Accelerator replacement for the reference's sequential two-heap beam search
(reference: src/antitopo_engine.h:495-708 ``query_k_at_layer``, :710-851
``query_k_bottom_compressed``, :853-928 ``_query_k``).  The redesign:

  * a batch of B queries advances in lockstep; per query the state is a
    fixed-size *sorted beam* ``(ids, dists, expanded-flags)`` of width ef —
    this one buffer plays the role of both the ``candidates`` min-heap and
    the ``nearest`` max-heap of the reference (a candidate is an unexpanded
    beam entry),
  * the visited hash-set + epoch array (reference :208-209,574-577,692-694)
    is replaced by duplicate-masking against the beam: a node currently in
    the beam is never re-added, and an evicted node can never re-enter
    because beams improve monotonically, so no infinite loops are possible;
    occasional re-scoring of evicted nodes costs only matmul flops,
  * per iteration each active query expands its best unexpanded beam entry:
    one adjacency-row gather, one vector-block gather, one batched matmul
    distance, one sorted merge (``lax.sort``) — no data-dependent shapes,
  * termination matches the reference break condition (stop once the best
    unexpanded candidate is worse than the beam's worst member and the beam
    is full, src/antitopo_engine.h:588-590) via per-query ``done`` flags
    inside a single ``lax.while_loop``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from expann_tpu.models.graph import GraphIndex
from expann_tpu.ops.distance import batched_neighbour_dist2, squared_norms

INF = jnp.inf


def _gather_dist2(data, data_norms, ids, q, qn, precision):
    """Gather rows ``ids`` (B, R) of ``data`` and score them against q.

    Sentinel rows carry a stored norm of +inf, so padded/invalid neighbours
    come out at distance +inf with no explicit masking.
    """
    nvecs = data[ids].astype(jnp.float32)
    nnorms = data_norms[ids]
    return batched_neighbour_dist2(q, nvecs, nnorms, q_norms=qn, precision=precision)


def _gather_score_ortho(
    data, data_norms, ids, q, qn,
    chosen_v, chosen_n, chosen_valid, ortho_factor, ortho_bias, precision,
):
    """Ortho-penalized scoring of gathered candidates (the construction-time
    ``use_ortho`` branch of the reference's query_k_at_layer,
    src/antitopo_engine.h:342-351):

        score(c) = d2(q,c) + sum over chosen p of
            [d2(p,c) < d2(q,c)] * (ortho_factor * (d2(q,c) - d2(p,c))
                                   + ortho_bias)

    ``chosen_v``/``chosen_n``: (B, OC, D) / (B, OC) pre-gathered entry
    points; invalid columns are masked by ``chosen_valid``.  Candidates at
    +inf stay +inf (0 * inf guards below).
    """
    nvecs = data[ids].astype(jnp.float32)
    nnorms = data_norms[ids]
    d2 = batched_neighbour_dist2(q, nvecs, nnorms, q_norms=qn, precision=precision)
    co_dots = jnp.einsum(
        "bod,bkd->bok", chosen_v, nvecs,
        preferred_element_type=jnp.float32,
    )  # (B, OC, K)
    co = chosen_n[:, :, None] + nnorms[:, None, :] - 2.0 * co_dots
    d2b = d2[:, None, :]
    hit = (co < d2b) & chosen_valid[:, :, None] & jnp.isfinite(d2b)
    pen = jnp.where(hit, ortho_factor * (d2b - co) + ortho_bias, 0.0)
    return d2 + jnp.sum(pen, axis=1)


def greedy_descent(
    data: jax.Array,
    data_norms: jax.Array,
    layer_slot: jax.Array,
    layer_adj: jax.Array,
    q: jax.Array,
    qn: jax.Array,
    ep: jax.Array,
    ep_d: jax.Array,
    precision: str = "highest",
) -> Tuple[jax.Array, jax.Array]:
    """Batched greedy walk on one upper layer.

    Replaces the repeat-until-no-improvement neighbour scan of the reference
    (src/antitopo_engine.h:878-893): each step every query moves to its best
    neighbour if that improves, and the loop runs until no query improves.
    """

    def body(state):
        ep, ep_d, _ = state
        nbrs = layer_adj[layer_slot[ep]]  # (B, Ru) global ids
        nd = _gather_dist2(data, data_norms, nbrs, q, qn, precision)
        j = jnp.argmin(nd, axis=-1)
        nd_min = jnp.take_along_axis(nd, j[:, None], axis=-1)[:, 0]
        best = jnp.take_along_axis(nbrs, j[:, None], axis=-1)[:, 0]
        better = nd_min < ep_d
        new_ep = jnp.where(better, best, ep)
        new_d = jnp.where(better, nd_min, ep_d)
        return new_ep, new_d, better.any()

    def cond(state):
        return state[2]

    # data-dependent True initializer (shard_map varying-axes consistency)
    improved0 = (ep == ep).all()
    ep, ep_d, _ = jax.lax.while_loop(cond, body, (ep, ep_d, improved0))
    return ep, ep_d


def beam_search(
    data: jax.Array,
    data_norms: jax.Array,
    adj: jax.Array,
    q: jax.Array,
    qn: jax.Array,
    ep_ids: jax.Array,
    ef: int,
    max_iters: int,
    sentinel: int,
    precision: str = "highest",
    expand: int = 1,
    ortho_chosen: jax.Array | None = None,
    ortho_valid: jax.Array | None = None,
    ortho_factor: float = 0.5,
    ortho_bias: float = 0.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Batched best-first beam search on one graph layer.

    Args:
      data/data_norms: ``(N + 1, D)`` corpus (f32 vectors or casted codes)
        with the +inf-norm sentinel row.
      adj: ``(N + 1, R)`` int32 adjacency with sentinel padding.
      q: ``(B, D)`` query block; qn: ``(B,)`` its squared norms.
      ep_ids: ``(B, E0)`` entry points.
      ef: beam width (the reference's ``ef_search`` / ``ef_construction``).
      ortho_chosen/ortho_valid: optional (B, OC) previously-chosen entry
        points; when given, every candidate is scored with the reference's
        construction-time ortho penalty.

    Returns ``(beam_ids, beam_d, num_distcomps)`` with beams sorted by
    ascending distance; padding entries carry id ``sentinel`` and d ``+inf``.
    ``num_distcomps`` is PER-QUERY ``(B,)`` so callers can exclude padded
    batch rows from the RECORD_STATS totals (reference counters:
    src/antitopo_engine.h:125-128).
    """
    B, E0 = ep_ids.shape
    R = adj.shape[1]

    if ortho_chosen is not None:
        safe = jnp.minimum(ortho_chosen, sentinel)
        chosen_v = data[safe].astype(jnp.float32)  # (B, OC, D)
        chosen_n = data_norms[safe]

        def score(ids_):
            return _gather_score_ortho(
                data, data_norms, ids_, q, qn,
                chosen_v, chosen_n, ortho_valid,
                ortho_factor, ortho_bias, precision,
            )

    else:

        def score(ids_):
            return _gather_dist2(data, data_norms, ids_, q, qn, precision)

    ep_d = score(ep_ids)
    # Dedup entry points (duplicate seeds would corrupt beam-dedup later).
    if E0 > 1:
        same = ep_ids[:, :, None] == ep_ids[:, None, :]
        earlier = jnp.tril(jnp.ones((E0, E0), bool), k=-1)[None]
        dup0 = (same & earlier).any(-1)
        ep_d = jnp.where(dup0, INF, ep_d)

    pad = max(ef - E0, 0)
    beam_ids = jnp.concatenate(
        [ep_ids, jnp.full((B, pad), sentinel, jnp.int32)], axis=1
    )
    beam_d = jnp.concatenate([ep_d, jnp.full((B, pad), INF)], axis=1)
    beam_exp = jnp.zeros((B, ef + max(E0 - ef, 0)), bool)[:, : beam_ids.shape[1]]
    # Sort the initial beam and truncate to ef.
    beam_d, beam_ids, beam_exp_i = jax.lax.sort(
        (beam_d, beam_ids, beam_exp.astype(jnp.int32)), num_keys=1
    )
    beam_d = beam_d[:, :ef]
    beam_ids = beam_ids[:, :ef]
    beam_exp = beam_exp_i[:, :ef].astype(bool)

    # Derive loop-carry initializers from the (possibly shard-varying) beam
    # data rather than fresh constants, so the while_loop carries have
    # consistent varying-manual-axes when running inside shard_map.
    ncomp0 = jnp.int32(E0) + beam_ids[:, 0] * 0  # (B,) per-query counts
    done0 = jnp.isnan(beam_d[:, 0])  # all False, but data-dependent
    it0 = jnp.int32(0) + beam_ids[0, 0] * 0

    E = max(1, min(expand, ef))

    def body(state):
        beam_ids, beam_d, beam_exp, done, it, ncomp = state
        masked = jnp.where(beam_exp, INF, beam_d)
        if E == 1:
            best_pos = jnp.argmin(masked, axis=-1)[:, None]  # (B, 1)
        else:
            # Speculative multi-expansion: take the E best unexpanded
            # entries per iteration.  Termination is still decided by the
            # best one alone (reference semantics); the extra expansions
            # are work the sequential algorithm may or may not have done,
            # traded for E-fold fewer serialized gather round-trips.
            _, best_pos = jax.lax.top_k(-masked, E)  # (B, E)
        sel_d = jnp.take_along_axis(masked, best_pos, axis=-1)  # (B, E)
        best_d = sel_d[:, 0]
        worst = beam_d[:, -1]
        # Reference break: cur > worst(nearest) with nearest full
        # (src/antitopo_engine.h:588-590); best_d == INF means nothing left
        # to expand.  INF-padded (not yet full) beams have worst == INF and
        # keep going, matching `nearest.size() == k`.
        done = done | (best_d > worst) | jnp.isinf(best_d)
        valid_sel = jnp.isfinite(sel_d) & ~done[:, None]  # (B, E)
        sel = jnp.where(
            valid_sel,
            jnp.take_along_axis(beam_ids, best_pos, axis=-1),
            jnp.int32(sentinel),
        )
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (B, E, beam_exp.shape[1]), 2)
            == best_pos[:, :, None]
        )
        beam_exp = beam_exp | (onehot & valid_sel[:, :, None]).any(axis=1)

        nbrs = adj[sel].reshape(B, E * R)  # sentinel rows: all-sentinel
        nd = score(nbrs)
        ncomp = ncomp + jnp.sum(nbrs != sentinel, axis=-1).astype(ncomp.dtype)
        K = nbrs.shape[1]  # E*R
        dup = (nbrs[:, :, None] == beam_ids[:, None, :]).any(-1)
        if E > 1:
            # dedup within the gathered block (two expanded vertices may
            # share a neighbour): keep only the first occurrence.
            same = nbrs[:, :, None] == nbrs[:, None, :]
            earlier = jnp.tril(jnp.ones((K, K), bool), k=-1)[None]
            dup = dup | (same & earlier).any(-1)
        nd = jnp.where(dup, INF, nd)

        all_d = jnp.concatenate([beam_d, nd], axis=1)
        all_ids = jnp.concatenate([beam_ids, nbrs], axis=1)
        all_exp = jnp.concatenate(
            [beam_exp, jnp.zeros((B, K), bool)], axis=1
        ).astype(jnp.int32)
        all_d, all_ids, all_exp = jax.lax.sort(
            (all_d, all_ids, all_exp), num_keys=1
        )
        return (
            all_ids[:, :ef],
            all_d[:, :ef],
            all_exp[:, :ef].astype(bool),
            done,
            it + 1,
            ncomp,
        )

    def cond(state):
        _, _, _, done, it, _ = state
        return (~done.all()) & (it < max_iters)

    state = (
        beam_ids,
        beam_d,
        beam_exp,
        done0,
        it0,
        ncomp0,
    )
    beam_ids, beam_d, _, _, _, ncomp = jax.lax.while_loop(cond, body, state)
    return beam_ids, beam_d, ncomp


@functools.partial(
    jax.jit,
    static_argnames=(
        "k",
        "ef",
        "max_iters",
        "precision",
        "compressed",
        "expand",
    ),
)
def query_batch(
    graph: GraphIndex,
    q: jax.Array,
    k: int,
    ef: int,
    max_iters: int = 0,
    precision: str = "highest",
    compressed: bool = False,
    expand: int = 1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Full batched query: descend upper layers greedily from the starting
    vertex, beam-search the bottom layer, return ``(ids, dists, distcomps)``
    with ``ids`` shaped ``(B, k)`` and ``distcomps`` per-query ``(B,)``
    (padded batch rows can then be excluded from the engine counters).

    Mirrors the reference ``_query_k`` flow (src/antitopo_engine.h:853-928):
    plain-L2 descent (the query path never uses the ortho penalty since
    ``entry_points`` is empty on the single pass, :863), then an ef-wide
    bottom beam; with ``compressed=True`` the beam scores uint8 codes with a
    floor()-truncated integer query (mirroring the uint32 cast at :726-737)
    and the final beam is exactly reranked in f32 (:845-848).
    """
    ef = max(ef, k)
    if max_iters <= 0:
        max_iters = 8 * ef + 16
    B = q.shape[0]
    q = q.astype(jnp.float32)
    qn = squared_norms(q)
    sentinel = graph.sentinel

    ep = jnp.full((B,), graph.starting_vertex, jnp.int32)
    ep_d = _gather_dist2(
        graph.vectors, graph.norms, ep[:, None], q, qn, precision
    )[:, 0]
    for layer in reversed(graph.layers):
        ep, ep_d = greedy_descent(
            graph.vectors,
            graph.norms,
            layer.slot,
            layer.adj,
            q,
            qn,
            ep,
            ep_d,
            precision,
        )

    if compressed:
        assert graph.codes is not None, "index was built without codes"
        if graph.quant_scale is not None:
            # ranged affine quantization: transform the query with the same
            # scale/offset as the stored codes (the reference's unused
            # quantizer_ranged_q8, src/quantizer.h:186-238, made live here);
            # ranking by quantized distance needs no 1/scale^2 factor and
            # the final rerank below is exact anyway.
            qc = jnp.clip(
                jnp.round(q * graph.quant_scale + graph.quant_offset),
                0.0,
                255.0,
            )
        else:
            # Integer-truncate the query exactly like the reference's
            # uint32_t(q[i]) swizzle load (src/antitopo_engine.h:726-737);
            # the x86 lane swizzle itself is dropped as an architecture
            # artifact.
            qc = jnp.floor(q)
        qcn = squared_norms(qc)
        beam_ids, _, ncomp = beam_search(
            graph.codes,
            graph.code_norms,
            graph.adj_bottom,
            qc,
            qcn,
            ep[:, None],
            ef=ef,
            max_iters=max_iters,
            sentinel=sentinel,
            precision=precision,
            expand=expand,
        )
        # Exact f32 rerank of the final beam (src/antitopo_engine.h:845-848).
        beam_d = _gather_dist2(
            graph.vectors, graph.norms, beam_ids, q, qn, precision
        )
        beam_d, beam_ids = jax.lax.sort((beam_d, beam_ids), num_keys=1)
    else:
        beam_ids, beam_d, ncomp = beam_search(
            graph.vectors,
            graph.norms,
            graph.adj_bottom,
            q,
            qn,
            ep[:, None],
            ef=ef,
            max_iters=max_iters,
            sentinel=sentinel,
            precision=precision,
            expand=expand,
        )
    return beam_ids[:, :k], beam_d[:, :k], ncomp
