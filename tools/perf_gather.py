"""Micro-benchmark of the beam-search hot op: gather (B, R) rows + batched
matmul distance, across storage dtypes.  Decides the serving data path:

  * f32    — gather materializes (B,R,D) f32
  * bf16   — half the gather bytes, bf16 x bf16 -> f32 on the tensor cores
  * u8->f32 — quarter gather bytes but XLA inserts a big f32 convert
  * i8     — centered int8 codes fed straight to the int8 matmul path
             (s8 x s8 -> s32), no float convert (exact integer distances)

Usage: python tools/perf_gather.py [--n 1000000] [--b 4096] [--r 128]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("iters", "mode"))
def bench_gather_dist(data, norms, q, qn, ids0, iters: int, mode: str):
    B, R = ids0.shape
    N = data.shape[0] - 1

    def body(i, carry):
        acc, ids = carry
        rows = data[ids]
        if mode == "i8":
            dots = jnp.einsum(
                "bd,bmd->bm",
                q,
                rows,
                preferred_element_type=jnp.int32,
            )
            d = qn[:, None] + norms[ids] - 2 * dots
            d = d.astype(jnp.float32)
        else:
            rows = rows.astype(jnp.float32) if mode == "u8f32" else rows
            dots = jnp.einsum(
                "bd,bmd->bm",
                q.astype(rows.dtype) if mode == "bf16" else q,
                rows,
                preferred_element_type=jnp.float32,
            )
            d = qn[:, None] + norms[ids] - 2.0 * dots
        # derive next ids from results to serialize iterations
        nxt = (ids + jnp.argmin(d, axis=1)[:, None] + i) % N
        return acc + jnp.sum(d), nxt

    acc, _ = jax.lax.fori_loop(0, iters, body, (jnp.float32(0), ids0))
    return acc


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--b", type=int, default=4096)
    p.add_argument("--r", type=int, default=128)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args()

    rng = np.random.default_rng(0)
    base = rng.integers(0, 218, (args.n + 1, args.d)).astype(np.float32)
    ids0 = jnp.asarray(
        rng.integers(0, args.n, (args.b, args.r)).astype(np.int32)
    )

    def run(mode):
        if mode == "f32":
            data = jnp.asarray(base)
            q = jnp.asarray(rng.integers(0, 218, (args.b, args.d)).astype(np.float32))
        elif mode == "bf16":
            data = jnp.asarray(base, jnp.bfloat16)
            q = jnp.asarray(
                rng.integers(0, 218, (args.b, args.d)).astype(np.float32)
            )
        elif mode == "u8f32":
            data = jnp.asarray(base, jnp.uint8)
            q = jnp.asarray(rng.integers(0, 218, (args.b, args.d)).astype(np.float32))
        elif mode == "i8":
            data = jnp.asarray(base - 128, jnp.int8)
            q = jnp.asarray(
                (rng.integers(0, 218, (args.b, args.d)) - 128).astype(np.int8)
            )
        if mode == "i8":
            norms = jnp.sum(
                data.astype(jnp.int32) * data.astype(jnp.int32), axis=-1
            )
            qn = jnp.sum(q.astype(jnp.int32) * q.astype(jnp.int32), axis=-1)
        else:
            norms = jnp.sum(
                data.astype(jnp.float32) * data.astype(jnp.float32), axis=-1
            )
            qn = jnp.sum(q.astype(jnp.float32) * q.astype(jnp.float32), axis=-1)
        # warmup/compile
        bench_gather_dist(data, norms, q, qn, ids0, iters=2, mode=mode).block_until_ready()
        t0 = time.perf_counter()
        bench_gather_dist(
            data, norms, q, qn, ids0, iters=args.iters, mode=mode
        ).block_until_ready()
        dt = time.perf_counter() - t0
        per_iter = dt / args.iters
        gathered_mb = args.b * args.r * args.d * data.dtype.itemsize / 1e6
        print(
            f"{mode:7s}: {per_iter * 1e3:7.2f} ms/iter  "
            f"(gather payload {gathered_mb:.0f} MB, "
            f"{gathered_mb / per_iter / 1e3:.0f} GB/s effective)",
            flush=True,
        )

    for mode in ["f32", "bf16", "u8f32", "i8"]:
        try:
            run(mode)
        except Exception as e:
            print(f"{mode}: FAILED {e!r}", flush=True)


@functools.partial(jax.jit, static_argnames=("iters",))
def bench_page_gather(pages, q, ids0, iters: int):
    """Gather (B, P) pages of 8 rows each (same total bytes as (B, 8P) row
    gathers) — tests whether gather cost is per-row or per-byte."""
    B, P = ids0.shape
    NP = pages.shape[0] - 1
    D = q.shape[1]

    def body(i, carry):
        acc, ids = carry
        rows = pages[ids]  # (B, P, 8 * D)
        rows = rows.reshape(B, P * 8, D)
        dots = jnp.einsum("bd,bmd->bm", q, rows, preferred_element_type=jnp.float32)
        nxt = (ids + jnp.argmin(dots, axis=1)[:, None] + i) % NP
        return acc + jnp.sum(dots), nxt

    acc, _ = jax.lax.fori_loop(0, iters, body, (jnp.float32(0), ids0))
    return acc


def page_main():
    rng = np.random.default_rng(0)
    N, D, B = 1_000_000, 128, 4096
    P = 16  # pages per query -> 128 effective rows
    pages = jnp.asarray(
        rng.standard_normal((N // 8 + 1, 8 * D)).astype(np.float32)
    )
    ids0 = jnp.asarray(rng.integers(0, N // 8, (B, P)).astype(np.int32))
    bench_page_gather(pages, jnp.ones((B, D), jnp.float32), ids0, iters=2).block_until_ready()
    t0 = time.perf_counter()
    iters = 50
    bench_page_gather(
        pages, jnp.ones((B, D), jnp.float32), ids0, iters=iters
    ).block_until_ready()
    per_iter = (time.perf_counter() - t0) / iters
    mb = B * P * 8 * D * 4 / 1e6
    print(
        f"page16 : {per_iter * 1e3:7.2f} ms/iter  (gather payload {mb:.0f} MB, "
        f"{mb / per_iter / 1e3:.0f} GB/s effective)",
        flush=True,
    )


if __name__ == "__main__":
    if "--pages" in sys.argv:
        page_main()
    else:
        main()
