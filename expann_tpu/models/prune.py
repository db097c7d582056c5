"""Vectorized anti-topological edge pruning.

Batched replacement for the reference's sequential greedy prune
(reference: src/antitopo_engine.h:262-308 ``prune_edges``).  The semantics,
restated: given a candidate edge list sorted by (distance, id), greedily
select up to ``cap`` edges; a candidate's score is its base distance plus an
orthogonality penalty ``ortho_factor * (d - co_dist) + ortho_bias`` for every
already-selected edge that lies closer to the candidate than the new vertex
does (``co_dist < d``), and a candidate is disqualified outright (score
+inf) once more than ``prune_overflow`` selected edges trigger the penalty
(the leniency counter at src/antitopo_engine.h:286-294).

The redesign runs W nodes' prunes in lockstep: the pairwise candidate
co-distance matrix ``(W, C, C)`` is one batched matmul, and each of the
``cap`` selection steps is an argmin + masked penalty update over the whole
``(W, C)`` candidate block — no heaps, no hash sets, and the penalty is
accumulated incrementally instead of being recomputed per scan.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

INF = jnp.inf


@functools.partial(jax.jit, static_argnames=("precision",))
def pairwise_co_dist(cand_vecs: jax.Array, cand_norms: jax.Array, precision: str = "highest") -> jax.Array:
    """All-pairs squared L2 among each node's candidates:
    ``(W, C, D) -> (W, C, C)`` via one batched matmul."""
    cand_vecs = cand_vecs.astype(jnp.float32)
    dots = jnp.einsum(
        "wcd,wed->wce",
        cand_vecs,
        cand_vecs,
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    co = cand_norms[:, :, None] + cand_norms[:, None, :] - 2.0 * dots
    return jnp.maximum(co, 0.0)


@functools.partial(
    jax.jit, static_argnames=("cap", "prune_overflow")
)
def antitopo_prune(
    cand_ids: jax.Array,  # (W, C) int32, sorted by (d, id); sentinel padding
    cand_d: jax.Array,  # (W, C) f32, +inf padding
    co: jax.Array,  # (W, C, C) f32 pairwise candidate distances
    cap: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    sentinel: int,
) -> Tuple[jax.Array, jax.Array]:
    """Batched greedy anti-topo selection.

    Returns ``(sel_ids, sel_d)`` of shape ``(W, cap)`` in *selection order*
    (matching the reference, which appends in selection order), padded with
    ``sentinel`` / +inf once selection stops (all remaining candidates
    disqualified or exhausted, src/antitopo_engine.h:297-303).
    """
    W, C = cand_d.shape
    valid = jnp.isfinite(cand_d)

    def step(j, state):
        penalty, hits, chosen, stopped, sel_ids, sel_d = state
        score = cand_d + penalty
        score = jnp.where(hits > prune_overflow, INF, score)
        score = jnp.where(chosen | ~valid, INF, score)
        # Candidates are pre-sorted by (d, id); argmin returns the first
        # minimum, reproducing the reference's std::set iteration order
        # tie-break (src/antitopo_engine.h:276,298).
        pick = jnp.argmin(score, axis=-1)  # (W,)
        pick_score = jnp.take_along_axis(score, pick[:, None], axis=-1)[:, 0]
        ok = jnp.isfinite(pick_score) & ~stopped
        stopped = stopped | ~ok

        picked_id = jnp.take_along_axis(cand_ids, pick[:, None], axis=-1)[:, 0]
        picked_d = jnp.take_along_axis(cand_d, pick[:, None], axis=-1)[:, 0]
        sel_ids = sel_ids.at[:, j].set(jnp.where(ok, picked_id, sentinel))
        sel_d = sel_d.at[:, j].set(jnp.where(ok, picked_d, INF))

        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, (W, C), 1) == pick[:, None]
        )
        chosen = chosen | (onehot & ok[:, None])

        co_row = jnp.take_along_axis(co, pick[:, None, None], axis=1)[:, 0, :]
        hit = (co_row < cand_d) & ok[:, None]
        penalty = penalty + jnp.where(
            hit, ortho_factor * (cand_d - co_row) + ortho_bias, 0.0
        )
        hits = hits + hit.astype(jnp.int32)
        return penalty, hits, chosen, stopped, sel_ids, sel_d

    state = (
        jnp.zeros((W, C), jnp.float32),
        jnp.zeros((W, C), jnp.int32),
        jnp.zeros((W, C), bool),
        jnp.zeros((W,), bool),
        jnp.full((W, cap), sentinel, jnp.int32),
        jnp.full((W, cap), INF, jnp.float32),
    )
    state = jax.lax.fori_loop(0, cap, step, state)
    return state[4], state[5]


def prune_candidates(
    vectors: jax.Array,
    norms: jax.Array,
    cand_ids: jax.Array,
    cand_d: jax.Array,
    cap: int,
    ortho_factor: float,
    ortho_bias: float,
    prune_overflow: int,
    sentinel: int,
    precision: str = "highest",
) -> Tuple[jax.Array, jax.Array]:
    """Convenience wrapper: gather candidate vectors, build the co-distance
    matrix, run the batched prune.  ``cand_ids`` / ``cand_d`` must already be
    sorted ascending by (d, id) with sentinel/+inf padding."""
    cand_vecs = vectors[cand_ids]
    cand_norms = jnp.where(
        jnp.isfinite(cand_d), norms[cand_ids], jnp.float32(jnp.inf)
    )
    co = pairwise_co_dist(cand_vecs, cand_norms, precision)
    return antitopo_prune(
        cand_ids,
        cand_d,
        co,
        cap=cap,
        ortho_factor=float(ortho_factor),
        ortho_bias=float(ortho_bias),
        prune_overflow=int(prune_overflow),
        sentinel=sentinel,
    )
