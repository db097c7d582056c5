"""Generate a SIFT1M-shaped dataset as REAL fvecs/ivecs files.

The image has no SIFT1M files and no network, so the CLI's Sift1M path
(`expann_tpu/cli.py` -> `load_sift1m("datasets/sift/...")`) has only ever
run on tiny format-test files.  This tool generates a full-scale stand-in
with SIFT's actual value regime so the dress rehearsal exercises exactly
what the real data would:

  * n=1,000,000 base vectors, d=128, m=10,000 queries (SIFT1M's shape,
    reference src/main.cpp:72-80),
  * components are u8-VALUED floats (integers in [0, 255] stored as f32 —
    fvecs files of real SIFT hold u8 descriptors promoted to float), the
    actual regime of `quantize_simple`'s uint8 cast
    (reference src/quantizer.h:132-141): the compressed grid half is
    exercised losslessly-castable data,
  * clustered geometry (data/loader.generate_synthetic_clustered — Zipf
    masses, anisotropic clusters) mapped into the u8 box, modelling real
    descriptor corpora rather than isotropic Gaussians,
  * ground truth: EXACT top-100 ivecs computed on-device (flat matmul
    scan), truncated by the loader to the config's k at load time like
    the real gt file.

Writes datasets/sift/sift_base.fvecs, sift_query.fvecs,
sift_groundtruth.ivecs (the CLI's hardcoded paths).  ~520MB on disk.

Run:  python tools/make_sift_like.py [--n 1000000] [--m 10000] [--out datasets/sift]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_vecs(path: str, mat: np.ndarray, as_int: bool = False) -> None:
    """fvecs/ivecs: each record is (int32 d, then d 4-byte items)
    (reference: src/dataset_loader.h:96-125).  Vectorized single write."""
    n, d = mat.shape
    if as_int:
        body = mat.astype(np.int32)
    else:
        body = mat.astype(np.float32).view(np.int32)
    rec = np.empty((n, d + 1), np.int32)
    rec[:, 0] = d
    rec[:, 1:] = body
    rec.tofile(path)


def exact_gt(x: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k ids on device, chunked over queries."""
    import jax
    import jax.numpy as jnp

    n, d = x.shape
    # the corpus rides as a jit OPERAND: a closed-over device array would
    # become an embedded constant of the compiled program
    xd = jnp.asarray(x)
    xn = jnp.sum(xd.astype(jnp.float32) ** 2, axis=1)

    @jax.jit
    def topk(qc, xd, xn):
        qn = jnp.sum(qc**2, axis=1)
        d2 = (
            qn[:, None]
            + xn[None, :]
            - 2.0
            * jax.lax.dot_general(
                qc, xd, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        )
        _, ids = jax.lax.top_k(-d2, k)
        return ids

    out = []
    B = 512
    for s in range(0, q.shape[0], B):
        qc = jnp.asarray(q[s : s + B])
        out.append(np.asarray(topk(qc, xd, xn)))
        if s % 4096 == 0:
            print(f"gt {s}/{q.shape[0]}", flush=True)
    return np.concatenate(out, axis=0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--out", default="datasets/sift")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from expann_tpu.data.loader import generate_sift_like

    t0 = time.time()
    print(f"generating clustered n={args.n} m={args.m} ...", flush=True)
    x, q = generate_sift_like(args.n, args.m, args.d, seed=args.seed)
    print(f"u8 box: x in [{x.min()}, {x.max()}]", flush=True)

    print("computing exact top-%d ground truth on device ..." % args.k,
          flush=True)
    gt = exact_gt(x, q, args.k)

    os.makedirs(args.out, exist_ok=True)
    write_vecs(os.path.join(args.out, "sift_base.fvecs"), x)
    write_vecs(os.path.join(args.out, "sift_query.fvecs"), q)
    write_vecs(os.path.join(args.out, "sift_groundtruth.ivecs"), gt,
               as_int=True)
    print(f"wrote {args.out}/ in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
