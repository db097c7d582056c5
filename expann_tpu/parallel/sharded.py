"""Multi-device scaling: corpus-sharded index over a device mesh.

This is new capability relative to the reference, which is single-process
with no distributed backend at all (SURVEY.md section 2, "Parallelism /
distributed-communication inventory": the only concurrency is a benchmark
job thread pool, src/bench_runner.h:15-58).  The design
(SURVEY.md section 5 "Distributed communication backend", section 7 step 7):

  * **corpus sharding (model-parallel analogue)**: the vector set and its
    graph are partitioned row-wise into one sub-index per device; arrays are
    stacked on a leading device axis and laid out with
    ``NamedSharding(P("shard"))`` so each device holds exactly its sub-index,
  * **query fan-out**: a query batch is replicated to every device via
    ``shard_map``; each device beam-searches its own sub-index concurrently;
    the per-shard top-k lists are exchanged with one all-gather and
    merged with a global sort — union-of-shards recall is at least
    single-index recall for the same ef,
  * **data-parallel queries**: with a replicated index, the query batch is
    instead sharded over the mesh (``P("shard")`` on the batch dim) and XLA
    runs each device's slice independently — the max-throughput serving mode,
  * **sharded build step**: candidate generation for a wave of new vectors
    runs corpus-sharded (each device scores the wave against its shard, one
    all-gather merges per-shard top-C candidate lists), and the anti-topo
    prune runs wave-sharded (each device prunes its slice of the wave) — the
    collective build loop the reference has no counterpart for.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from expann_tpu.models.build import BuildConfig, build_index
from expann_tpu.models.graph import GraphIndex
from expann_tpu.models.prune import antitopo_prune, pairwise_co_dist
from expann_tpu.models.search import beam_search
from expann_tpu.ops.distance import pad_dim, pairwise_dist2, squared_norms
from expann_tpu.ops.pallas_topk import flat_topk, prepare_corpus

AXIS = "shard"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


@dataclasses.dataclass
class ShardedIndex:
    """S stacked single-shard sub-indexes, device-sharded on the leading
    axis.  Per-shard global ids are ``shard * n_shard + local``.

    Upper HNSW layers are stacked per level across shards (padded to the
    max member count / degree; shards missing a level get all-sentinel
    rows, making descent a no-op there), so every shard's beam starts
    from a hierarchically descended entry point exactly like the
    single-device engine (reference upper-layer descent:
    src/antitopo_engine.h:878-893).
    """

    vectors: jax.Array  # (S, n_shard + 1, D)
    norms: jax.Array  # (S, n_shard + 1)
    adj: jax.Array  # (S, n_shard + 1, R)
    start: jax.Array  # (S,) per-shard entry point
    n_total: int
    mesh: Mesh
    # stacked upper layers, level-major: slot maps local id -> adj row
    # (sentinel nl_max for non-members), adj stores LOCAL ids (sentinel
    # n_shard); tuples have one entry per level, bottom-up
    layer_slots: Tuple[jax.Array, ...] = ()  # each (S, n_shard + 1)
    layer_adjs: Tuple[jax.Array, ...] = ()  # each (S, nl_max + 1, Ru)

    @property
    def n_shard(self) -> int:
        return self.vectors.shape[1] - 1

    @property
    def num_shards(self) -> int:
        return self.vectors.shape[0]


def build_sharded(
    x: np.ndarray, cfg: Optional[BuildConfig] = None, mesh: Optional[Mesh] = None
) -> ShardedIndex:
    """Partition the corpus row-wise and build one sub-index per device.

    Shard assignment is contiguous blocks (global id = shard * n_shard +
    local), with the last shard padded by unreachable +inf-norm rows.
    """
    cfg = cfg or BuildConfig()
    mesh = mesh or make_mesh()
    S = mesh.devices.size
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    n_shard = (n + S - 1) // S

    vec_blocks, norm_blocks, adj_blocks, starts = [], [], [], []
    shard_layers = []  # per shard: list of (slot (local_n+1,), adj (n_l+1, Ru))
    R = None
    for s in range(S):
        part = x[s * n_shard : (s + 1) * n_shard]
        g = build_index(part, cfg)
        v = np.asarray(g.vectors)
        nm = np.asarray(g.norms)
        a = np.asarray(g.adj_bottom)
        shard_layers.append(
            [(np.asarray(L.slot), np.asarray(L.adj)) for L in g.layers]
        )
        local_n = part.shape[0]
        if local_n < n_shard:
            # pad to the common shard width with unreachable sentinel rows
            pad = n_shard - local_n
            v = np.concatenate(
                [v[:local_n], np.zeros((pad, v.shape[1]), np.float32), v[local_n:]]
            )
            nm = np.concatenate(
                [nm[:local_n], np.full(pad, np.inf, np.float32), nm[local_n:]]
            )
            a = np.where(a == local_n, n_shard, a)
            a = np.concatenate(
                [a[:local_n], np.full((pad, a.shape[1]), n_shard, np.int32), a[local_n:]]
            )
        R = a.shape[1] if R is None else max(R, a.shape[1])
        vec_blocks.append(v)
        norm_blocks.append(nm)
        adj_blocks.append(a)
        starts.append(int(g.starting_vertex))

    R = max(r.shape[1] for r in adj_blocks)
    adj_blocks = [
        np.pad(a, ((0, 0), (0, R - a.shape[1])), constant_values=n_shard)
        for a in adj_blocks
    ]

    # ---- stack upper layers level-major across shards ----
    # pad each level to the max member count / degree; a shard missing the
    # level gets an all-sentinel slot table, making its descent a no-op
    n_levels = max((len(ls) for ls in shard_layers), default=0)
    layer_slots, layer_adjs = [], []
    for lvl in range(n_levels):
        have = [
            ls[lvl] if lvl < len(ls) else None for ls in shard_layers
        ]
        nl_max = max(sl[1].shape[0] - 1 for sl in have if sl is not None)
        ru_max = max(sl[1].shape[1] for sl in have if sl is not None)
        slots = np.full((S, n_shard + 1), nl_max, np.int32)
        adjs = np.full((S, nl_max + 1, ru_max), n_shard, np.int32)
        for s, sl in enumerate(have):
            if sl is None:
                continue
            slot, adj_l = sl
            n_l = adj_l.shape[0] - 1
            local_np1 = slot.shape[0]
            # member slots carry over; the shard's own sentinel (n_l) and
            # any shard-padding rows map to the common sentinel nl_max
            s_fix = np.where(slot >= n_l, nl_max, slot)
            slots[s, : local_np1 - 1] = s_fix[:-1]
            # adj stores local ids w/ shard sentinel local_n -> n_shard
            a_fix = np.where(adj_l >= local_np1 - 1, n_shard, adj_l)
            adjs[s, :n_l, : adj_l.shape[1]] = a_fix[:n_l]
        layer_slots.append(slots)
        layer_adjs.append(adjs)

    sharding = NamedSharding(mesh, P(AXIS))
    return ShardedIndex(
        vectors=jax.device_put(np.stack(vec_blocks), sharding),
        norms=jax.device_put(np.stack(norm_blocks), sharding),
        adj=jax.device_put(np.stack(adj_blocks), sharding),
        start=jax.device_put(np.asarray(starts, np.int32), sharding),
        n_total=n,
        mesh=mesh,
        layer_slots=tuple(
            jax.device_put(s, sharding) for s in layer_slots
        ),
        layer_adjs=tuple(jax.device_put(a, sharding) for a in layer_adjs),
    )


@functools.partial(
    jax.jit, static_argnames=("k", "ef", "max_iters", "n_shard", "mesh", "precision")
)
def _sharded_query(
    vectors, norms, adj, start, layer_slots, layer_adjs, q,
    k: int, ef: int, max_iters: int,
    n_shard: int, mesh: Mesh, precision: str
):
    """Replicated queries fan out to every shard; each shard descends its
    own upper layers greedily, beam-searches its bottom layer, and the
    per-shard beams are all-gathered (the out-spec resharding)
    and merged."""
    from expann_tpu.models.search import _gather_dist2, greedy_descent

    def per_shard(vec, nrm, a, st, slots, adjs, q):
        vec, nrm, a = vec[0], nrm[0], a[0]
        qn = squared_norms(q)
        B = q.shape[0]
        ep = jnp.broadcast_to(st, (B,)).astype(jnp.int32)
        ep_d = _gather_dist2(vec, nrm, ep[:, None], q, qn, precision)[:, 0]
        for sl, al in zip(reversed(slots), reversed(adjs)):
            ep, ep_d = greedy_descent(
                vec, nrm, sl[0], al[0], q, qn, ep, ep_d, precision
            )
        ids, d, _ = beam_search(
            vec, nrm, a, q, qn, ep[:, None],
            ef=ef, max_iters=max_iters, sentinel=n_shard, precision=precision,
        )
        shard_id = jax.lax.axis_index(AXIS)
        gids = jnp.where(
            ids[:, :k] >= n_shard, -1, ids[:, :k] + shard_id * n_shard
        )
        return gids[None], d[:, :k][None]

    L = len(layer_slots)
    gids, d = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            P(AXIS), P(AXIS), P(AXIS), P(AXIS),
            (P(AXIS),) * L, (P(AXIS),) * L, P(),
        ),
        out_specs=(P(AXIS), P(AXIS)),
    )(vectors, norms, adj, start, layer_slots, layer_adjs, q)
    # (S, B, k) -> global top-k merge
    S, B, _ = gids.shape
    all_d = jnp.transpose(d, (1, 0, 2)).reshape(B, S * k)
    all_i = jnp.transpose(gids, (1, 0, 2)).reshape(B, S * k)
    all_d, all_i = jax.lax.sort((all_d, all_i), num_keys=1)
    return all_i[:, :k], all_d[:, :k]


def sharded_query_batch(
    index: ShardedIndex,
    queries: np.ndarray,
    k: int,
    ef: int,
    max_iters: int = 0,
    precision: str = "highest",
) -> np.ndarray:
    q = np.asarray(queries, np.float32)
    q = pad_dim(q, index.vectors.shape[-1])
    if max_iters <= 0:
        max_iters = 8 * max(ef, k) + 16
    ids, _ = _sharded_query(
        index.vectors,
        index.norms,
        index.adj,
        index.start,
        index.layer_slots,
        index.layer_adjs,
        jnp.asarray(q),
        k=k,
        ef=max(ef, k),
        max_iters=max_iters,
        n_shard=index.n_shard,
        mesh=index.mesh,
        precision=precision,
    )
    return np.asarray(ids)


@functools.partial(
    jax.jit,
    static_argnames=("C", "cap", "prune_overflow", "n_shard", "mesh", "precision"),
)
def sharded_build_step(
    vectors, norms, wave, C: int, cap: int,
    ortho_factor, ortho_bias, prune_overflow: int,
    n_shard: int, mesh: Mesh, precision: str = "highest",
):
    """One corpus-sharded candidate-generation + wave-sharded prune step —
    the distributed analogue of the reference's per-insert candidate search
    + prune_edges (src/antitopo_engine.h:396-440), expressed as two matmuls
    and two collectives instead of a sequential pointer walk:

      1. every device scores the (replicated) wave against its corpus shard
         and selects its local top-C (matmul + sort),
      2. one all-gather concatenates the S local candidate lists;
         a merge-sort keeps the global top-C per wave vector,
      3. the wave is then split across devices (data-parallel) and each device
         runs the batched anti-topo prune on its slice.

    Returns (sel_ids, sel_d) of shape (W, cap) with *global* candidate ids.
    """

    def per_shard(vec, nrm, wave):
        vec, nrm = vec[0], nrm[0]
        qn = squared_norms(wave)
        d2 = pairwise_dist2(wave, vec, x_norms=nrm, q_norms=qn, precision=precision)
        local_ids = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        d2s, idss = jax.lax.sort((d2, local_ids), num_keys=1)
        shard_id = jax.lax.axis_index(AXIS)
        gids = jnp.where(
            idss[:, :C] >= n_shard, -1, idss[:, :C] + shard_id * n_shard
        )
        return gids[None], d2s[:, :C][None]

    gids, gd = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
    )(vectors, norms, wave)
    S = gids.shape[0]
    W = wave.shape[0]
    cat_d = jnp.transpose(gd, (1, 0, 2)).reshape(W, S * C)
    cat_i = jnp.transpose(gids, (1, 0, 2)).reshape(W, S * C)
    cat_d, cat_i = jax.lax.sort((cat_d, cat_i), num_keys=2)
    cand_d, cand_ids = cat_d[:, :C], cat_i[:, :C]

    # wave-sharded prune: gather candidate vectors from the (sharded)
    # corpus — XLA inserts the cross-shard collective gathers — then run
    # the batched greedy prune data-parallel over the wave dimension.
    flat_vecs = vectors[:, :n_shard].reshape(-1, vectors.shape[-1])
    safe = jnp.maximum(cand_ids, 0)
    cvecs = flat_vecs[safe]
    cnorms = jnp.where(
        (cand_ids >= 0) & jnp.isfinite(cand_d),
        squared_norms(cvecs.reshape(-1, cvecs.shape[-1])).reshape(cand_d.shape),
        jnp.inf,
    )
    co = pairwise_co_dist(cvecs, cnorms, precision)
    sentinel = vectors.shape[0] * n_shard
    sel_ids, sel_d = antitopo_prune(
        jnp.where(cand_ids < 0, sentinel, cand_ids),
        jnp.where(cand_ids < 0, jnp.inf, cand_d),
        co,
        cap=cap,
        ortho_factor=ortho_factor,
        ortho_bias=ortho_bias,
        prune_overflow=prune_overflow,
        sentinel=sentinel,
    )
    return sel_ids, sel_d


def replicated_query_dp(
    graph: GraphIndex,
    queries: np.ndarray,
    k: int,
    ef: int,
    mesh: Optional[Mesh] = None,
    precision: str = "highest",
) -> np.ndarray:
    """Data-parallel serving: replicated index, batch sharded over the mesh
    (max-QPS mode).  Plain jit with shardings — XLA partitions the batch."""
    from expann_tpu.models.search import query_batch

    mesh = mesh or make_mesh()
    q = np.asarray(queries, np.float32)
    q = pad_dim(q, graph.vectors.shape[1])
    S = mesh.devices.size
    pad = (-q.shape[0]) % S
    if pad:
        q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
    q_sharded = jax.device_put(q, NamedSharding(mesh, P(AXIS)))
    rep = NamedSharding(mesh, P())
    graph_rep = jax.device_put(graph, rep)
    ids, _, _ = query_batch(graph_rep, q_sharded, k=k, ef=ef, precision=precision)
    ids = np.asarray(ids)
    return ids[: ids.shape[0] - pad] if pad else ids


# ---------------------------------------------------------------------------
# Sharded flat scan: corpus-sharded flat_topk fan-out
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedFlat:
    """Row-sharded bf16 corpus for the flat-scan engine: each device scans
    its shard with the flat_topk kernel concurrently; one all-gather merges
    the per-shard top-k lists, so recall equals the single-device scan."""

    x: jax.Array  # (S, n_pad, D) bf16, device-sharded on axis 0
    norms: jax.Array  # (S, n_pad) f32, +inf on padding rows
    n_shard: int  # real rows per shard (the last shard may have fewer)
    n_total: int
    mesh: Mesh


def build_sharded_flat(x: np.ndarray, mesh: Optional[Mesh] = None) -> ShardedFlat:
    mesh = mesh or make_mesh()
    S = mesh.devices.size
    x = pad_dim(np.asarray(x, np.float32))
    n = x.shape[0]
    n_shard = (n + S - 1) // S
    parts = [
        prepare_corpus(x[s * n_shard : (s + 1) * n_shard], min_rows=n_shard)
        for s in range(S)
    ]
    sharding = NamedSharding(mesh, P(AXIS))
    return ShardedFlat(
        x=jax.device_put(jnp.stack([p.x for p in parts]), sharding),
        norms=jax.device_put(jnp.stack([p.norms for p in parts]), sharding),
        n_shard=n_shard,
        n_total=n,
        mesh=mesh,
    )


@functools.partial(jax.jit, static_argnames=("k", "n_shard", "mesh"))
def _sharded_flat_query(xs, xn, q, k: int, n_shard: int, mesh: Mesh):
    def per_shard(xs, xn, q):
        ids, d = flat_topk(q, xs[0], xn[0], k=k)
        shard = jax.lax.axis_index(AXIS)
        # padding rows score +inf and come back as ids >= n_shard
        gids = jnp.where(ids >= n_shard, -1, ids + shard * n_shard)
        d = jnp.where(ids >= n_shard, jnp.inf, d)
        return gids[None], d[None]

    # check_vma=False: pallas_call outputs don't carry varying-mesh-axes
    # metadata, so shard_map's vma checker cannot type them
    gids, d = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    )(xs, xn, q)
    S, B, _ = gids.shape
    all_d = jnp.transpose(d, (1, 0, 2)).reshape(B, S * k)
    all_i = jnp.transpose(gids, (1, 0, 2)).reshape(B, S * k)
    all_d, all_i = jax.lax.sort((all_d, all_i), num_keys=1)
    return all_i[:, :k], all_d[:, :k]


def sharded_flat_query(index: ShardedFlat, queries: np.ndarray, k: int) -> np.ndarray:
    """Replicated queries, per-shard flat scan, global top-k merge."""
    q = pad_dim(np.asarray(queries, np.float32), index.x.shape[-1])
    ids, _ = _sharded_flat_query(
        index.x, index.norms, jnp.asarray(q),
        k=k, n_shard=index.n_shard, mesh=index.mesh,
    )
    return np.asarray(ids)
