"""Matmul-distance primitives.

Replacement for the reference's AVX-512 L2^2 kernels
(reference: src/distance.h:86-148 ``distance_compare_avx512f_f16[_batch128]``,
src/vec.h:139-156 ``dist/dist2``).  Instead of one-vector-at-a-time SIMD FMA
loops, every distance here is a batched matrix product:

    d2(q, x) = |q|^2 + |x|^2 - 2 q.x

All arrays are padded so the feature dimension is a multiple of 128 (a row
is then a whole number of 128-byte cache lines in every storage dtype,
int8 included); zero padding leaves L2 distances unchanged (the reference
imposes the analogous constraint DIM % 64 == 0 at compile time,
reference: CMakeLists.txt:100-101, and zero-pads inputs in
src/pyrunner.cpp:20-27).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

LANE = 128  # feature-dim padding target (see module docstring)
SUBLANE = 8  # default row padding target for 2-D tiles


def pad_dim(x, multiple: int = LANE):
    """Zero-pad the last (feature) dimension up to ``multiple``."""
    d = x.shape[-1]
    pad = (-d) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    if isinstance(x, np.ndarray):
        return np.pad(x, widths)
    return jnp.pad(x, widths)


def pad_rows(x, multiple: int = SUBLANE, fill=0):
    """Pad the first (row) dimension up to ``multiple`` with ``fill``."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    if isinstance(x, np.ndarray):
        return np.pad(x, widths, constant_values=fill)
    return jnp.pad(x, widths, constant_values=fill)


def squared_norms(x: jax.Array) -> jax.Array:
    """Row-wise squared L2 norms of an ``(N, D)`` array -> ``(N,)``."""
    x = x.astype(jnp.float32)
    return jnp.sum(x * x, axis=-1)


@functools.partial(jax.jit, static_argnames=("precision",))
def pairwise_dist2(
    q: jax.Array,
    x: jax.Array,
    x_norms: jax.Array | None = None,
    q_norms: jax.Array | None = None,
    precision: str = "highest",
) -> jax.Array:
    """All-pairs squared L2 distances ``(B, D) x (N, D) -> (B, N)``.

    One matmul replaces B*N scalar kernel invocations of the reference
    (src/distance.h:86-111).  ``precision='highest'`` runs the f32 matmul in
    full f32 precision so distances match numpy closely; ``'default'``
    trades accuracy for speed (on the GPU an f32 matmul at ``'default'``
    runs in TF32, about three decimal digits).
    """
    q = q.astype(jnp.float32)
    x = x.astype(jnp.float32)
    if q_norms is None:
        q_norms = squared_norms(q)
    if x_norms is None:
        x_norms = squared_norms(x)
    dots = jnp.dot(
        q, x.T, preferred_element_type=jnp.float32, precision=precision
    )
    d2 = q_norms[:, None] + x_norms[None, :] - 2.0 * dots
    return jnp.maximum(d2, 0.0)


@functools.partial(jax.jit, static_argnames=("precision",))
def batched_neighbour_dist2(
    q: jax.Array,
    nbr_vecs: jax.Array,
    nbr_norms: jax.Array,
    q_norms: jax.Array | None = None,
    precision: str = "highest",
) -> jax.Array:
    """Per-query candidate distances ``(B, D) x (B, M, D) -> (B, M)``.

    The beam-search hot loop: each query scores its own gathered neighbour
    block.  Replaces the reference's per-neighbour software-pipelined scoring
    loop (src/antitopo_engine.h:637-688) with one batched contraction.
    """
    q = q.astype(jnp.float32)
    nbr_vecs = nbr_vecs.astype(jnp.float32)
    if q_norms is None:
        q_norms = squared_norms(q)
    dots = jnp.einsum(
        "bd,bmd->bm",
        q,
        nbr_vecs,
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    d2 = q_norms[:, None] + nbr_norms - 2.0 * dots
    return jnp.maximum(d2, 0.0)
