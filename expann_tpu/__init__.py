"""expann_tpu — an approximate-nearest-neighbour framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of jacketsj/expANN
(reference: an AVX-512 C++20 HNSW-variant library with "anti-topological"
orthogonality-penalized graph construction, uint8 scalar quantization with
exact rerank, and a recall-vs-QPS benchmark harness).

Design (accelerator-first, not a port):
  * vectors live as ``(N, D)`` device arrays with the feature dimension
    padded to a multiple of 128; all distances are matmul-distances
    ``|q|^2 + |x|^2 - 2 q.x``
    (replaces reference src/distance.h AVX-512 kernels),
  * graph adjacency is a dense padded ``(N, M)`` int32 array per layer
    (replaces reference pointer-chasing ``hadj_flat``/``hadj_bottom``),
  * queries run as batched beam search with sorted fixed-size beams and
    expansion flags instead of heaps + hash-set visited marks
    (replaces reference src/antitopo_engine.h query_k_at_layer),
  * construction proceeds in waves of batched inserts with a vectorized
    anti-topo prune (replaces the sequential _store_vector loop),
  * multi-device scaling shards the corpus over a ``jax.sharding.Mesh`` with
    per-shard search + all-gather top-k merge (new capability; the
    reference is single-process).
"""

__version__ = "0.1.0"

from expann_tpu.utils.runtime import configure as _configure_runtime

_configure_runtime()

from expann_tpu.models.brute_force import BruteForceEngine
from expann_tpu.models.antitopo import AntitopoEngine

__all__ = [
    "BruteForceEngine",
    "AntitopoEngine",
    "__version__",
]
