"""Flat k-NN scan: distance GEMM fused with a running top-k selection.

Replaces the reference's scalar linear scan + heap
(reference: src/brute_force_engine.h:29-46).  Writing the (B, N) distance
matrix and then selecting over it moves 4·B·N bytes for 2·B·N·D FLOPs of
GEMM, far below the card's FLOP-per-byte ridge; fusing the selection into
the GEMM reads the corpus and the queries once and writes only (B, k).

``flat_topk`` is a Pallas kernel on the Triton route over a corpus
prepared by ``prepare_corpus`` (rows padded to ``ROW_ALIGN``; padding rows
carry a +inf squared norm, so they score +inf and never enter a top-k).
Each program owns one query tile and one contiguous split of the corpus,
and loops over corpus blocks inside the kernel: ``pl.dot`` scores the
block (bf16 with f32 accumulation, or int8 with int32 accumulation), and
the tile's running top-k stays in registers.  A block is merged only as
far as it can contribute: one reduction counts, per row, the candidates
that beat the row's current k-th distance, and only ``max(count)``
extract/insert passes run (late blocks rarely contribute, so most blocks
cost the GEMM and one compare).  Per-split lists are merged by one small
sort.  On an H100 it beats the plain XLA version (chunked GEMM +
``lax.top_k`` + running merge, kept in tools/perf_flat_topk.py) at both
of its call sites, flat serving and build candidates (PERF.md).

Distances are those of the stored representation (bf16-rounded vectors, or
int8 codes in code space); use ``BruteForceEngine(mode="exact")`` as the
ground-truth oracle.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from expann_tpu.utils import runtime

ROW_ALIGN = 4096  # corpus row padding; every split size below divides it
MAX_K = 128  # per-split list width the kernel keeps in registers
# Enough programs to give every SM of an H100 (132) two of them.
TARGET_PROGRAMS = 264
NUM_WARPS = 4
_BIG = 3.0e38  # "empty slot" distance: worse than any real one, below +inf


@dataclasses.dataclass
class FlatCorpus:
    """A corpus laid out for the flat scan.

    ``x``: (N_pad, D_pad) bf16 or int8; ``norms``: (N_pad,) f32 squared
    norms of the stored rows, +inf on padding rows.  For int8 codes,
    ``center``/``scale`` map a float query into code space
    (``quantize_query_i8``)."""

    x: jax.Array
    norms: jax.Array
    n: int
    center: np.ndarray | None = None
    scale: float = 1.0


def _pad_width(d: int) -> int:
    """Feature width the kernel loads: a power of two (Triton block
    shapes), at least 32 (int8 tensor-core operand depth)."""
    return max(32, pl.next_power_of_2(d))


def _layout(rows: np.ndarray, dtype, min_rows: int) -> Tuple[jax.Array, jax.Array]:
    n, d = rows.shape
    n_pad = max(n, min_rows)
    n_pad += (-n_pad) % ROW_ALIGN
    out = np.zeros((n_pad, _pad_width(d)), rows.dtype)
    out[:n, :d] = rows
    xf = out[:n].astype(np.float32)
    norms = np.full(n_pad, np.inf, np.float32)
    norms[:n] = (xf * xf).sum(axis=1)
    return jnp.asarray(out, dtype), jnp.asarray(norms)


def prepare_corpus(
    x: np.ndarray, dtype=jnp.bfloat16, min_rows: int = 0
) -> FlatCorpus:
    """Pad + upload a host corpus for the flat scan.  ``dtype`` is
    ``jnp.bfloat16`` (norms of the bf16-rounded rows) or ``jnp.int8``
    (centered symmetric codes, one shared scale: distances are
    shift-invariant and a common scale keeps the ranking of integer
    distances monotone in the true ones).  Rows are padded to at least
    ``min_rows``, then to a multiple of ``ROW_ALIGN``."""
    x = np.asarray(x, np.float32)
    if dtype == jnp.int8:
        center = x.mean(axis=0)
        xc = x - center
        scale = 127.0 / (float(np.abs(xc).max()) or 1.0)
        codes = np.clip(np.rint(xc * scale), -127, 127).astype(np.int8)
        xd, norms = _layout(codes, jnp.int8, min_rows)
        return FlatCorpus(xd, norms, x.shape[0], center, scale)
    import ml_dtypes

    xd, norms = _layout(x.astype(ml_dtypes.bfloat16), jnp.bfloat16, min_rows)
    return FlatCorpus(xd, norms, x.shape[0])


def quantize_query_i8(q: np.ndarray, center: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(
        np.rint((np.asarray(q, np.float32) - center) * scale), -127, 127
    ).astype(np.int8)


def _tiles(k: int) -> Tuple[int, int, int]:
    """(query tile, corpus block, list width K) for a given k: the running
    list is (Bt, K) distances + ids in registers, the block's scores
    (Bt, G) beside it, over NUM_WARPS warps."""
    K = max(16, pl.next_power_of_2(k))
    if K <= 16:
        return 64, 128, K
    if K <= 64:
        return 32, 128, K
    return 32, 64, K


def _splits(n_tiles: int, n_pad: int, G: int) -> int:
    """Corpus splits (second grid axis) so that small query batches still
    put ``TARGET_PROGRAMS`` programs on the card."""
    s = 1
    while s * n_tiles < TARGET_PROGRAMS and n_pad % (2 * s * G) == 0:
        s *= 2
    return s


def _scan_kernel(q_ref, x_ref, xn_ref, d_ref, i_ref, *, k, K, G, n_split):
    Bt = q_ref.shape[0]
    q = q_ref[...]
    if q.dtype == jnp.int8:
        qi = q.astype(jnp.int32)
        qn = jnp.sum(qi * qi, axis=1).astype(jnp.float32)
    else:
        qf = q.astype(jnp.float32)
        qn = jnp.sum(qf * qf, axis=1)
    base = pl.program_id(1) * n_split
    slot = jax.lax.broadcasted_iota(jnp.int32, (Bt, K), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (Bt, G), 1)
    # slots >= k sit at -inf: never the row's worst, never replaced
    run_d = jnp.where(slot < k, _BIG, -jnp.inf).astype(jnp.float32)
    run_i = jnp.full((Bt, K), -1, jnp.int32)

    def block(j, carry):
        run_d, run_i = carry
        rows = pl.ds(pl.multiple_of(j * G, G), G)
        x = x_ref[rows, :]
        xn = xn_ref[rows]
        dots = pl.dot(q, x, trans_b=True).astype(jnp.float32)
        dd = qn[:, None] + xn[None, :] - 2.0 * dots  # (Bt, G)
        worst = jnp.max(run_d, axis=1)
        cnt = jnp.sum((dd < worst[:, None]).astype(jnp.int32), axis=1)
        passes = jnp.minimum(jnp.max(cnt), k)

        def insert(_, c):
            dd, run_d, run_i = c
            m = jnp.min(dd, axis=1)
            pos = jnp.argmin(dd, axis=1).astype(jnp.int32)
            w = jnp.max(run_d, axis=1)
            w_slot = jnp.argmax(run_d, axis=1).astype(jnp.int32)
            take = (slot == w_slot[:, None]) & (m < w)[:, None]
            run_d = jnp.where(take, m[:, None], run_d)
            run_i = jnp.where(take, (base + j * G + pos)[:, None], run_i)
            dd = jnp.where(col == pos[:, None], jnp.inf, dd)
            return dd, run_d, run_i

        _, run_d, run_i = jax.lax.fori_loop(
            0, passes, insert, (dd, run_d, run_i)
        )
        return run_d, run_i

    run_d, run_i = jax.lax.fori_loop(0, n_split // G, block, (run_d, run_i))
    d_ref[...] = run_d
    i_ref[...] = run_i


def _merge(d, ids, k: int, n_pad: int):
    """(B, L) unsorted candidate lists -> ascending (ids, d2) of width k;
    empty slots come back as id ``n_pad`` at +inf."""
    empty = (d >= _BIG) | (ids < 0)
    d = jnp.where(empty, jnp.inf, jnp.maximum(d, 0.0))
    ids = jnp.where(empty, n_pad, ids)
    d, ids = jax.lax.sort((d, ids), num_keys=2)
    return ids[:, :k], d[:, :k]


def _cast_query(q, x_dtype):
    if x_dtype == jnp.int8:
        # int8 corpora need int8 queries quantized with the corpus's own
        # center and scale (quantize_query_i8), not a cast
        assert q.dtype == jnp.int8, "int8 corpus requires int8 queries"
        return q
    return q.astype(x_dtype)


def _pad_query(q, width: int, multiple: int):
    B, D = q.shape
    return jnp.pad(q, ((0, (-B) % multiple), (0, width - D)))


@functools.partial(jax.jit, static_argnames=("k",))
def flat_topk(q: jax.Array, x: jax.Array, xn: jax.Array, k: int):
    """Top-k of every query against a prepared corpus (``x``/``xn`` of a
    ``FlatCorpus``): returns ``(ids, d2)`` of shape (B, k), ascending by
    (distance, id).  Any B; ``k <= MAX_K``."""
    assert 1 <= k <= MAX_K, f"flat_topk supports 1 <= k <= {MAX_K}"
    B = q.shape[0]
    n_pad, width = x.shape
    Bt, G, K = _tiles(k)
    qp = _pad_query(_cast_query(q, x.dtype), width, Bt)
    n_tiles = qp.shape[0] // Bt
    S = _splits(n_tiles, n_pad, G)
    n_split = n_pad // S
    d, ids = pl.pallas_call(
        functools.partial(_scan_kernel, k=k, K=K, G=G, n_split=n_split),
        grid=(n_tiles, S),
        in_specs=[
            pl.BlockSpec((Bt, width), lambda i, s: (i, 0)),
            pl.BlockSpec((n_split, width), lambda i, s: (s, 0)),
            pl.BlockSpec((n_split,), lambda i, s: (s,)),
        ],
        out_specs=[
            pl.BlockSpec((None, Bt, K), lambda i, s: (s, i, 0)),
            pl.BlockSpec((None, Bt, K), lambda i, s: (s, i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((S, qp.shape[0], K), jnp.float32),
            jax.ShapeDtypeStruct((S, qp.shape[0], K), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=3),
        interpret=runtime.pallas_interpret(),
        name="flat_topk_scan",
    )(qp, x, xn)
    # (S, Bp, K) -> (Bp, S * k): the first k slots of each split's list
    d = jnp.transpose(d[:, :B, :k], (1, 0, 2)).reshape(B, S * k)
    ids = jnp.transpose(ids[:, :B, :k], (1, 0, 2)).reshape(B, S * k)
    return _merge(d, ids, k, n_pad)
