"""Exact k-NN by one matmul + top-k.

Counterpart of the reference's linear-scan + size-k max-heap
brute force engine (reference: src/brute_force_engine.h:29-46).  The scan
becomes a single ``(B, N)`` matmul-distance and the heap becomes
``lax.top_k``; it doubles as the ground-truth oracle for synthetic datasets
(reference: src/dataset_loader.h:27-39) and as the recall oracle in tests.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from expann_tpu.models.base import Engine, ParamList, _concat_pending
from expann_tpu.ops.distance import LANE, pad_dim, pairwise_dist2, squared_norms
from expann_tpu.ops.pallas_topk import (
    MAX_K,
    flat_topk,
    prepare_corpus,
    quantize_query_i8,
)


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def _exact_topk(q, x, x_norms, k: int, precision: str = "highest"):
    d2 = pairwise_dist2(q, x, x_norms=x_norms, precision=precision)
    neg_d, idx = jax.lax.top_k(-d2, k)
    return idx, -neg_d


def _rerank_body(q, x, x_norms, cand_ids, k: int, precision: str):
    n = x.shape[0]
    safe = jnp.clip(cand_ids, 0, n - 1)
    # rerank_store='bf16' keeps the corpus at 2 B/dim; score in f32
    cv = x[safe].astype(jnp.float32)  # (B, m, D)
    cn = jnp.where((cand_ids >= 0) & (cand_ids < n), x_norms[safe], jnp.inf)
    qn = jnp.sum(q * q, axis=1, keepdims=True)
    d2 = qn + cn - 2.0 * jnp.einsum(
        "bd,bmd->bm", q, cv,
        preferred_element_type=jnp.float32, precision=precision,
    )
    d2, ids = jax.lax.sort((d2, cand_ids), num_keys=1)
    return ids[:, :k], d2[:, :k]


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def _rerank_exact(q, x, x_norms, cand_ids, k: int, precision: str = "highest"):
    """f32 rerank of per-query candidate ids: gather, score, top-k.
    Out-of-range ids (kernel sentinels) score +inf.  Exact only at
    ``precision="highest"``: on the GPU an f32 matmul at "default" runs
    in TF32."""
    return _rerank_body(q, x, x_norms, cand_ids, k, precision)


@functools.partial(jax.jit, static_argnames=("k", "precision"))
def _rerank_dequant(
    qk, center, inv_scale, x, x_norms, cand_ids, k: int, precision: str
):
    """Rerank against the DEQUANTIZED i8 query (``query_wire='i8'``): the
    host ships 1 B/dim and the f32 rerank query is reconstructed on device
    as ``codes * inv_scale + center``.  The rerank corpus stays exact, so
    the only error vs ``_rerank_exact`` is the query's quantization noise
    (|err| <= 0.5/scale per dim)."""
    qd = qk.astype(jnp.float32) * inv_scale + center[None, :]
    return _rerank_body(qd, x, x_norms, cand_ids, k, precision)


class BruteForceEngine(Engine):
    """Exact nearest neighbours over an in-device corpus.

    Three serving modes:
      * ``mode='exact'``: XLA matmul + lax.top_k at ``precision`` — the
        ground-truth oracle (used for synthetic dataset GT) when
        ``precision='highest'``.
      * ``mode='fused'``: the flat-scan kernel (ops/pallas_topk.py) over a
        bf16 corpus — the serving path; never materializes the (B, N)
        distance matrix.  Near-exact (bf16 rounding of corpus and queries)
        — NOT a ground-truth oracle; use mode='exact' for GT.
      * ``mode='fused_i8'``: the same kernel over centered int8 codes
        (int8 tensor cores, half the corpus bytes of bf16), scanning for
        ``rerank_mult * k`` candidates which are then reranked in f32 at
        ``precision``.  ``rerank_store='bf16'`` keeps the rerank corpus in
        bf16 (2 B/dim instead of 4): a near-exact rerank at half the
        device memory.  ``query_wire='i8'`` ships only the int8 query
        codes and reranks against the dequantized query; the default
        ``'f32'`` ships the exact query too.
    """

    def __init__(
        self,
        batch_size: int = 1024,
        precision: str = "highest",
        mode: str = "exact",
        rerank_mult: int = 3,
        rerank_store: str = "f32",
        query_wire: str = "f32",
    ):
        self.rerank_store = rerank_store
        self.query_wire = query_wire
        self._pending: List[np.ndarray] = []
        self._x = None
        self._x_norms = None
        self._flat = None  # FlatCorpus of the fused modes
        self._i8_center_dev = None
        self._i8_inv_scale = None
        self.n = 0
        self.dim = 0
        self.batch_size = batch_size
        self.precision = precision
        self.mode = mode
        self.rerank_mult = rerank_mult

    def name(self) -> str:
        return "Brute-Force Engine"

    def param_list(self) -> ParamList:
        return {}

    def store_vector(self, v: np.ndarray) -> None:
        self._pending.append(
            np.asarray(v, dtype=np.float32).reshape(1, -1)
        )

    def store_many_vectors(self, vs: np.ndarray, take_norms: bool = False) -> None:
        vs = np.asarray(vs, dtype=np.float32)
        if vs.ndim != 2:
            raise ValueError("Input should be a 2D array")
        if take_norms:
            norms = np.linalg.norm(vs, axis=1, keepdims=True)
            vs = vs / np.maximum(norms, 1e-30)
        # keep 2D blocks intact: extending row-by-row costs ~100B of
        # array-object overhead per vector (gigabytes at 10M+ rows)
        # and makes the build-time stack a 20M-element python loop
        self._pending.append(vs)

    def build(self) -> None:
        assert self._pending or self._x is not None, "no vectors stored"
        if self._pending:
            x = _concat_pending(self._pending)
            self._pending = []
            self.n, self.dim = x.shape
            x = pad_dim(x)
            if self.mode == "fused":
                self._flat = prepare_corpus(x, jnp.bfloat16)
            elif self.mode == "fused_i8":
                self._flat = prepare_corpus(x, jnp.int8)
                self._i8_center_dev = jnp.asarray(
                    self._flat.center, jnp.float32
                )
                self._i8_inv_scale = jnp.float32(1.0 / self._flat.scale)
                # rerank corpus: exact f32, or near-exact bf16 at half
                # the device memory (rerank_store='bf16')
                if self.rerank_store == "bf16":
                    self._x = jnp.asarray(x, jnp.bfloat16)
                    # norms on host: uploading the f32 corpus just to
                    # square it would transiently double device memory
                    self._x_norms = jnp.asarray((x * x).sum(axis=1))
                else:
                    self._x = jnp.asarray(x)
                    self._x_norms = squared_norms(self._x)
            else:
                self._x = jnp.asarray(x)
                self._x_norms = squared_norms(self._x)

    def _query_fused(self, q: np.ndarray, k: int) -> np.ndarray:
        i8 = self.mode == "fused_i8"
        scan_k = min(self.rerank_mult * k, MAX_K) if i8 else k
        flat = self._flat
        # Split the batch into chunks and dispatch them all before the
        # first host read-back, so JAX's async dispatch overlaps each
        # chunk's transfer with the previous chunk's scan.
        bs = max(self.batch_size, min(q.shape[0], 16384))

        def _prep(start):
            """Chunk quantize + device upload, run one chunk ahead of the
            dispatch loop on a worker thread."""
            chunk = q[start : start + bs]
            if not i8:
                return chunk, jnp.asarray(chunk)
            return chunk, jnp.asarray(
                quantize_query_i8(chunk, flat.center, flat.scale)
            )

        starts = list(range(0, q.shape[0], bs))
        ex = ThreadPoolExecutor(max_workers=1) if len(starts) > 1 else None
        pending = []
        fut = None
        for idx_s, start in enumerate(starts):
            chunk, qk = fut.result() if fut is not None else _prep(start)
            if ex is not None and idx_s + 1 < len(starts):
                fut = ex.submit(_prep, starts[idx_s + 1])
            ids, _ = flat_topk(qk, flat.x, flat.norms, k=scan_k)
            if i8:
                if self.query_wire == "i8":
                    ids, _ = _rerank_dequant(
                        qk, self._i8_center_dev, self._i8_inv_scale,
                        self._x, self._x_norms, ids, k=k,
                        precision=self.precision,
                    )
                else:
                    ids, _ = _rerank_exact(
                        jnp.asarray(chunk), self._x, self._x_norms, ids,
                        k=k, precision=self.precision,
                    )
            pending.append(ids)
        if ex is not None:
            ex.shutdown(wait=True)
        return np.concatenate([np.asarray(ids) for ids in pending], axis=0)

    def query_k_batch(self, queries: np.ndarray, k: int) -> np.ndarray:
        assert (
            self._x is not None or self._flat is not None
        ), "build() must be called before queries"
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2:
            raise ValueError("queries must be 2D")
        width = self.dim + (-self.dim) % LANE
        q = pad_dim(q, width)
        if q.shape[-1] != width:
            raise ValueError("query dim exceeds corpus dim")
        if self.mode in ("fused", "fused_i8"):
            return self._query_fused(q, k)
        out = []
        bs = self.batch_size
        for start in range(0, q.shape[0], bs):
            chunk = jnp.asarray(q[start : start + bs])
            idx, _ = _exact_topk(
                chunk, self._x, self._x_norms, k, precision=self.precision
            )
            out.append(np.asarray(idx))
        return np.concatenate(out, axis=0)
