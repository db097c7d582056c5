"""Uniform engine interface.

Counterpart of the reference's CRTP ``ann_engine`` base
(reference: src/ann_engine.h:16-29): every engine exposes ``name`` /
``param_list`` / ``store_vector`` / ``build`` / ``query_k``.  Because the new
framework is batched-first, engines additionally expose
``store_many_vectors`` (bulk ingest, matching the pybind11 helper in
reference src/pyrunner.cpp:60-82) and ``query_k_batch`` (the native batched
entry point; ``query_k`` is a convenience wrapper over a batch of one).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

ParamList = Dict[str, str]


def _concat_pending(blocks: List[np.ndarray]) -> np.ndarray:
    """Assemble stored vector blocks into one (N, D) f32 matrix without a
    gratuitous copy when a single contiguous block was stored (the 10M+
    row ingest path: a second 10GB host copy is real money there)."""
    x = blocks[0] if len(blocks) == 1 else np.concatenate(blocks, axis=0)
    return np.ascontiguousarray(x, dtype=np.float32)


def format_param(value) -> str:
    """Render a param value the way the reference's add_param macro does
    (reference: src/ann_engine.h:10-14 uses std::to_string)."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        # std::to_string(float) uses 6 fixed decimals.
        return f"{value:.6f}"
    return str(value)


class Engine:
    """Protocol base class for ANN engines."""

    def name(self) -> str:
        raise NotImplementedError

    def param_list(self) -> ParamList:
        raise NotImplementedError

    def store_vector(self, v: np.ndarray) -> None:
        raise NotImplementedError

    def store_many_vectors(self, vs: np.ndarray, take_norms: bool = False) -> None:
        """Bulk ingest of a 2-D array of vectors; optionally L2-normalize
        each row first (reference: src/pyrunner.cpp:60-82)."""
        vs = np.asarray(vs, dtype=np.float32)
        if vs.ndim != 2:
            raise ValueError("Input should be a 2D array")
        if take_norms:
            norms = np.linalg.norm(vs, axis=1, keepdims=True)
            vs = vs / np.maximum(norms, 1e-30)
        for row in vs:
            self.store_vector(row)

    def build(self) -> None:
        raise NotImplementedError

    def query_k(self, v: np.ndarray, k: int) -> List[int]:
        return [int(i) for i in self.query_k_batch(np.asarray(v)[None, :], k)[0]]

    def query_k_batch(self, queries: np.ndarray, k: int) -> np.ndarray:
        """Batched k-NN: ``(B, D) -> (B, k)`` int array of ids.

        The hot path: queries are scored in large batches so the device
        sees big contractions instead of one-at-a-time scalar loops.
        """
        raise NotImplementedError

    def reset_stats(self) -> None:
        """Zero RECORD_STATS counters (reference: reset on build,
        src/antitopo_engine.h:488-492; exposed so harnesses can exclude
        untimed warmup dispatches from the reported counts)."""
        for attr in (
            "num_distcomps",
            "num_distcomps_compressed",
        ):
            if hasattr(self, attr):
                setattr(self, attr, 0)
        if hasattr(self, "total_query_time_ns"):
            self.total_query_time_ns = 0.0
