"""Device-resident layered graph index.

Device-array replacement for the reference's pointer-chasing adjacency
(reference: src/antitopo_engine.h:200-205 ``hadj_flat`` / ``hadj_bottom`` /
``hadj_flat_with_lengths``).  Everything is a dense, padded, fixed-shape
device array so gathers and distance matmuls compile to fixed shapes:

  * ``vectors``: ``(N + 1, D_pad)`` f32.  Row ``N`` is an all-zeros dummy row
    whose stored norm is ``+inf`` — any distance computed against it via
    ``|q|^2 + |x|^2 - 2 q.x`` comes out ``+inf``, so sentinel neighbours
    mask themselves with zero extra control flow.
  * ``adj_bottom``: ``(N + 1, R0)`` int32 edge ids, sentinel ``N`` padding;
    row ``N`` is all-sentinel so expanding a finished query is a no-op.
  * upper layers are compact: a layer keeps only its member nodes
    (``adj`` indexed by slot) plus a global-id -> slot lookup table,
    mirroring how the reference's HNSW hierarchy shrinks geometrically
    (layer draw: src/antitopo_engine.h:323).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from expann_tpu.ops.distance import pad_dim, squared_norms, LANE


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class UpperLayer:
    """One HNSW layer above the bottom.

    ``slot`` maps a global vector id to its row in ``adj`` (non-members map
    to the sentinel row ``n_l``).  ``adj`` stores *global* ids so descent
    never needs to translate back.
    """

    slot: jax.Array  # (N + 1,) int32 -> row in adj, sentinel n_l
    adj: jax.Array  # (n_l + 1, Ru) int32 global ids, sentinel N

    def tree_flatten(self):
        return (self.slot, self.adj), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GraphIndex:
    """A built index: corpus + layered adjacency (+ optional uint8 codes)."""

    vectors: jax.Array  # (N + 1, D_pad) f32, dummy last row
    norms: jax.Array  # (N + 1,) f32, norms[N] = +inf
    adj_bottom: jax.Array  # (N + 1, R0) int32, sentinel N
    layers: Tuple[UpperLayer, ...]  # layer 1 .. max_layer - 1 (may be empty)
    starting_vertex: jax.Array  # () int32
    codes: Optional[jax.Array] = None  # (N + 1, D_pad) uint8 quantized corpus
    code_norms: Optional[jax.Array] = None  # (N + 1,) f32 norms of codes
    # affine quantization params (ranged-q8 mode); None => plain cast codes
    quant_scale: Optional[jax.Array] = None  # () f32
    quant_offset: Optional[jax.Array] = None  # () f32

    @property
    def n(self) -> int:
        return self.vectors.shape[0] - 1

    @property
    def sentinel(self) -> int:
        return self.vectors.shape[0] - 1

    def tree_flatten(self):
        children = (
            self.vectors,
            self.norms,
            self.adj_bottom,
            self.layers,
            self.starting_vertex,
            self.codes,
            self.code_norms,
            self.quant_scale,
            self.quant_offset,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def make_corpus(x: np.ndarray) -> Tuple[jax.Array, jax.Array]:
    """Pad an ``(N, D)`` host array into the ``(N + 1, D_pad)`` device corpus
    with the +inf-norm dummy row used for sentinel masking."""
    x = np.asarray(x, dtype=np.float32)
    n, _ = x.shape
    xp = pad_dim(x, LANE)
    xp = np.concatenate([xp, np.zeros((1, xp.shape[1]), np.float32)], axis=0)
    vectors = jnp.asarray(xp)
    norms = squared_norms(vectors)
    norms = norms.at[n].set(jnp.inf)
    return vectors, norms
