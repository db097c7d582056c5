"""The Anti-Topo engine: public API.

Engine with the same surface as the reference's
``antitopo_engine<float>`` and its pybind11 bindings
(reference: src/antitopo_engine.h:103-260, src/pyrunner.cpp:55-91):
constructor params ``(M, ef_construction, ortho_count, prune_overflow,
use_compression)``, plus ``store_vector`` / ``store_many_vectors`` /
``build`` / ``query_k`` / ``query_k_numpy`` / ``set_ef_search`` / ``name`` /
``param_list``.  Internally everything is batched and device-resident; the
one-at-a-time methods are conveniences over the batched paths.

Stats parity: ``num_distcomps`` counts full-precision distance evaluations
performed by queries and ``num_distcomps_compressed`` the quantized ones,
mirroring the RECORD_STATS counters (reference:
src/antitopo_engine.h:125-129); both reset on ``build`` and on
``set_ef_search`` (:189-195, :488-492).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from expann_tpu.models.base import (
    Engine,
    ParamList,
    _concat_pending,
    format_param,
)
from expann_tpu.models.build import BuildConfig, build_index
from expann_tpu.models.graph import GraphIndex
from expann_tpu.models.search import query_batch
from expann_tpu.ops.distance import pad_dim
from expann_tpu.ops.quantize import quantize_simple


@dataclasses.dataclass
class AntitopoConfig:
    """Full parameter set, mirroring antitopo_engine_config
    (reference: src/antitopo_engine.h:72-101)."""

    M: int = 60
    M0: int = 0  # 0 -> 2 * M
    ef_search_mult: int = 1
    ef_search: Optional[int] = None
    ef_construction: int = 500
    ortho_count: int = 1
    ortho_factor: float = 0.5
    ortho_bias: float = 0.0
    prune_overflow: int = 0
    use_compression: bool = False
    use_largest_direction_filtering: bool = False  # no-op, as in reference
    index_filename: str = ""
    read_index: bool = False
    write_index: bool = False
    # knobs with no reference counterpart:
    seed: int = 0
    precision: str = "highest"
    prune_cand: int = 0  # candidate-list cap fed to the prune; 0 -> auto
    query_block: int = 1024
    query_expand: int = 1  # beam entries expanded per traversal iteration
    builder: str = "auto"  # "oneshot" | "wave" | "auto"
    wave_size: int = 1024
    wave_expand: int = 4  # wave-builder beam expansion rows per iteration
    wave_overflow_rows: int = 128  # fullest rows repruned per wave
    refine_frac: float = 0.0  # two-pass refinement fraction after wave builds
    # quantization mode for use_compression: "simple" (uint8 cast, the
    # reference's live path) or "ranged" (min/max affine q8, the principled
    # variant the reference defines but never instantiates)
    quant_mode: str = "simple"

    def __post_init__(self):
        if self.M0 == 0:
            self.M0 = 2 * self.M


class AntitopoEngine(Engine):
    """Anti-Topo Engine+ over device-resident batched graph search."""

    def __init__(
        self,
        M: int = 60,
        ef_construction: int = 500,
        ortho_count: int = 1,
        prune_overflow: int = 0,
        use_compression: bool = False,
        config: Optional[AntitopoConfig] = None,
    ):
        if config is None:
            config = AntitopoConfig(
                M=M,
                ef_construction=ef_construction,
                ortho_count=ortho_count,
                prune_overflow=prune_overflow,
                use_compression=use_compression,
            )
        self.cfg = config
        self._pending: List[np.ndarray] = []
        self.graph: Optional[GraphIndex] = None
        self.n = 0
        self.dim = 0
        self.num_distcomps = 0
        self.num_distcomps_compressed = 0
        # RECORD_STATS counterpart: accumulated wall-clock of query calls
        # (reference: total_query_time, src/antitopo_engine.h:128,855-856)
        self.total_query_time_ns = 0.0

    # --- identity / params -------------------------------------------------
    def name(self) -> str:
        return "Anti-Topo Engine+"

    def param_list(self) -> ParamList:
        c = self.cfg
        pl: ParamList = {
            "M": format_param(c.M),
            "M0": format_param(c.M0),
            "ef_search_mult": format_param(c.ef_search_mult),
            "ef_construction": format_param(c.ef_construction),
            "ortho_count": format_param(c.ortho_count),
            "ortho_factor": format_param(c.ortho_factor),
            "ortho_bias": format_param(c.ortho_bias),
            "prune_overflow": format_param(c.prune_overflow),
            "use_compression": format_param(c.use_compression),
            "use_largest_direction_filtering": format_param(
                c.use_largest_direction_filtering
            ),
            "num_distcomps": format_param(self.num_distcomps),
            "num_distcomps_compressed": format_param(
                self.num_distcomps_compressed
            ),
        }
        return pl

    # --- ingest ------------------------------------------------------------
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

    # --- build -------------------------------------------------------------
    def build(self) -> None:
        c = self.cfg
        if c.index_filename and (c.read_index or c.write_index):
            # auto-resolve read vs write by file existence, like the
            # reference constructor (src/antitopo_engine.h:137-155)
            from expann_tpu.utils.persist import index_exists

            if c.read_index:
                if index_exists(c.index_filename):
                    c.write_index = False
                else:
                    c.read_index = False
        if c.read_index and c.index_filename:
            from expann_tpu.utils.persist import load_index

            self.graph, meta = load_index(c.index_filename)
            self.n = self.graph.n
            self.dim = int(meta.get("dim", self.graph.vectors.shape[1]))
        elif self.graph is not None and self._pending:
            # store -> build -> store -> build ACCUMULATES, matching the
            # reference whose construction is insert-at-a-time into the
            # live graph (src/antitopo_engine.h:310-330): continue
            # wave-batched inserts over the existing index.
            from expann_tpu.models.wavebuild import extend_index_wave

            new_x = _concat_pending(self._pending)
            self._pending = []
            assert new_x.shape[1] == self.dim, "dim mismatch on extend"
            bc = self._build_config()
            self.graph = extend_index_wave(
                self.graph, new_x, bc, wave_size=self.cfg.wave_size
            )
            self.n = self.graph.n
        else:
            assert self._pending, "no vectors stored"
            x = _concat_pending(self._pending)
            self._pending = []
            self.n, self.dim = x.shape
            self.graph = build_index(x, self._build_config())
            if c.write_index and c.index_filename:
                from expann_tpu.utils.persist import save_index

                save_index(c.index_filename, self.graph, {"dim": self.dim})
        if c.use_compression and self.graph.codes is None:
            self._attach_codes()
        # reset stats before queries (src/antitopo_engine.h:488-492)
        self.num_distcomps = 0
        self.num_distcomps_compressed = 0

    def _build_config(self) -> BuildConfig:
        c = self.cfg
        return BuildConfig(
            M=c.M,
            M0=c.M0,
            ef_construction=c.ef_construction,
            ortho_count=c.ortho_count,
            ortho_factor=c.ortho_factor,
            ortho_bias=c.ortho_bias,
            prune_overflow=c.prune_overflow,
            prune_cand=c.prune_cand,
            seed=c.seed,
            precision=c.precision,
            builder=c.builder,
            wave_size=c.wave_size,
            wave_expand=c.wave_expand,
            wave_overflow_rows=c.wave_overflow_rows,
            refine_frac=c.refine_frac,
        )

    def _attach_codes(self) -> None:
        """Quantize the corpus per cfg.quant_mode (reference: build-time
        quant->build call, src/antitopo_engine.h:485-486)."""
        import jax.numpy as _jnp

        if self.cfg.quant_mode == "ranged":
            from expann_tpu.ops.quantize import (
                quantize_ranged,
                ranged_scale_offset,
            )

            real = np.asarray(self.graph.vectors[: self.n, : self.dim])
            scale, offset = ranged_scale_offset(real)
            codes, code_norms = quantize_ranged(self.graph.vectors, scale, offset)
            self.graph = dataclasses.replace(
                self.graph,
                codes=codes,
                code_norms=code_norms,
                quant_scale=_jnp.float32(scale),
                quant_offset=_jnp.float32(offset),
            )
        else:
            codes, code_norms = quantize_simple(self.graph.vectors)
            self.graph = dataclasses.replace(
                self.graph, codes=codes, code_norms=code_norms
            )

    # --- query -------------------------------------------------------------
    def set_ef_search(self, ef_search: int) -> None:
        self.cfg.ef_search = int(ef_search)
        self.num_distcomps = 0
        self.num_distcomps_compressed = 0
        self.total_query_time_ns = 0.0

    def _ef(self, k: int) -> int:
        if self.cfg.ef_search is not None:
            return max(int(self.cfg.ef_search), k)
        return max(k * self.cfg.ef_search_mult, k)

    def query_k_batch(self, queries: np.ndarray, k: int) -> np.ndarray:
        import time as _time

        assert self.graph is not None, "build() must be called before queries"
        t_begin = _time.perf_counter_ns()
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2:
            raise ValueError("queries must be 2D")
        q = pad_dim(q, self.graph.vectors.shape[1])
        ef = self._ef(k)
        bs = self.cfg.query_block
        # quantized serving: the beam scores uint8 codes, the final beam is
        # reranked in exact f32 (models/search.query_batch)
        compressed = bool(
            self.cfg.use_compression and self.graph.codes is not None
        )

        out = []
        for start in range(0, q.shape[0], bs):
            chunk = q[start : start + bs]
            real = chunk.shape[0]
            # Bucket the batch dimension to the next power of two so each
            # (B, ef) shape compiles once and is reused (jit shapes are
            # static; unbounded shape variety would mean unbounded
            # recompiles).
            bucket = 8
            while bucket < real:
                bucket *= 2
            bucket = min(bucket, bs)
            if real < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - real, q.shape[1]), np.float32)]
                )
            ids, _, ncomp = query_batch(
                self.graph,
                jnp.asarray(chunk),
                k=k,
                ef=ef,
                precision=self.cfg.precision,
                compressed=compressed,
                expand=self.cfg.query_expand,
            )
            # defer host conversion: converting inside the loop would
            # block each chunk and serialize transfer against compute
            # (JAX dispatch is async; the flat engine does the same)
            out.append((ids, ncomp, real))
        res = []
        for ids, ncomp, real in out:
            res.append(np.asarray(ids)[:real])
            # per-query counts: padded batch rows are excluded, mirroring
            # how they are excluded from results (RECORD_STATS exactness)
            nc = int(np.asarray(ncomp)[:real].sum())
            if self.cfg.use_compression:
                # traversal scores quantized codes; the final beam is
                # reranked in exact f32 (ef full-precision comps/query),
                # split across the two reference counters
                # (src/antitopo_engine.h:125-128, :845-848)
                self.num_distcomps_compressed += nc
                self.num_distcomps += real * ef
            else:
                self.num_distcomps += nc
        self.total_query_time_ns += _time.perf_counter_ns() - t_begin
        return np.concatenate(res, axis=0)

    def query_k(self, v: np.ndarray, k: int) -> List[int]:
        ids = self.query_k_batch(np.asarray(v, np.float32)[None, :], k)[0]
        return [int(i) for i in ids if i < self.n][:k]

    # reference pybind alias (src/pyrunner.cpp:84-90)
    def query_k_numpy(self, v: np.ndarray, k: int) -> List[int]:
        return self.query_k(v, k)
