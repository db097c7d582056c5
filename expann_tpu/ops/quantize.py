"""Scalar quantization of the corpus.

Counterpart of the reference's quantizers
(reference: src/quantizer.h):

  * ``quantize_simple``: the live path — elementwise cast float -> uint8
    (``quantizer_simple<uint8_t>``, src/quantizer.h:132-141, instantiated at
    src/antitopo_engine.h:197-199).  Works because SIFT components are small
    non-negative integers; out-of-range values clip.
  * ``quantize_ranged``: the principled min/max-range affine variant the
    reference defines but never instantiates
    (``quantizer_ranged_q8``, src/quantizer.h:186-238), ported here as a
    first-class option: codes = round(scale * x + offset) clipped to
    [0, 255], with distances rescaled by 1/scale^2.

Either way the codes live as a ``(N + 1, D_pad)`` uint8 array — 4x fewer
device-memory bytes per gathered neighbour block than f32.  Scoring casts
gathered codes to f32 and reuses the matmul-distance; all involved
integers are < 2^24 so f32 arithmetic is exact.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np


def quantize_simple(vectors: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cast-quantize the padded corpus (including the dummy row) to uint8.

    Returns ``(codes, code_norms)`` where the dummy row's norm is +inf so
    sentinel masking keeps working in the compressed beam search.
    """
    f = jnp.clip(vectors.astype(jnp.float32), 0.0, 255.0)
    codes = f.astype(jnp.uint8)
    cf = codes.astype(jnp.float32)
    norms = jnp.sum(cf * cf, axis=-1)
    norms = norms.at[-1].set(jnp.inf)
    return codes, norms


def ranged_scale_offset(x: np.ndarray) -> Tuple[float, float]:
    """Global min/max affine parameters (src/quantizer.h:214-219):
    scale = 256 / (max - min), offset = -scale * min."""
    mx = float(np.max(x))
    mn = float(np.min(x))
    scale = 256.0 / max(mx - mn, 1e-30)
    offset = -scale * mn
    return scale, offset


def quantize_ranged(
    vectors: jnp.ndarray, scale: float, offset: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Affine-quantize the padded corpus to uint8 codes."""
    f = jnp.round(vectors.astype(jnp.float32) * scale + offset)
    codes = jnp.clip(f, 0.0, 255.0).astype(jnp.uint8)
    cf = codes.astype(jnp.float32)
    norms = jnp.sum(cf * cf, axis=-1)
    norms = norms.at[-1].set(jnp.inf)
    return codes, norms
