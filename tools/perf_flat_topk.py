"""Time the flat top-k kernel against a plain XLA version on the GPU.

    python tools/perf_flat_topk.py [--n 1000000] [--reps 5] [--out FILE]

Shapes (d = 128, corpus and queries drawn on the device from a seed):
  * flat serving: B = 16384 queries, k = 10, bf16 and int8 corpora;
  * build candidates: W = 4096 queries, k = 128, bf16 corpus.
For each shape it first checks that the kernel and the plain version
return the same lists, then reports the median of ``--reps`` timed calls
(``block_until_ready``; compile excluded) of each, with the card's name
and power limit.  Rows with B <= 4096 also time the kernel with the
corpus split (its second grid axis) turned off, to show what the split
buys when the query tiles alone cannot fill the card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from expann_tpu.ops import pallas_topk as pt  # noqa: E402


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def flat_topk_plain(
    q: jax.Array, x: jax.Array, xn: jax.Array, k: int, chunk: int = 32768
):
    """Plain XLA version of ``flat_topk`` (same arguments and result):
    GEMM + ``lax.top_k`` per corpus chunk, merged into a running (B, k)
    list, so the (B, N) matrix is never materialized."""
    B = q.shape[0]
    n_pad, width = x.shape
    chunk = min(chunk, n_pad)
    while n_pad % chunk:
        chunk //= 2
    qc = pt._pad_query(pt._cast_query(q, x.dtype), width, 1)
    acc = jnp.int32 if x.dtype == jnp.int8 else jnp.float32
    qn = jnp.sum(jnp.square(qc.astype(acc)), axis=1).astype(jnp.float32)

    def step(carry, c):
        best_d, best_i = carry
        xc = jax.lax.dynamic_slice_in_dim(x, c * chunk, chunk)
        xnc = jax.lax.dynamic_slice_in_dim(xn, c * chunk, chunk)
        dots = jax.lax.dot_general(
            qc, xc, (((1,), (1,)), ((), ())), preferred_element_type=acc
        ).astype(jnp.float32)
        dd = qn[:, None] + xnc[None, :] - 2.0 * dots
        neg, pos = jax.lax.top_k(-dd, k)
        all_d = jnp.concatenate([best_d, -neg], axis=1)
        all_i = jnp.concatenate([best_i, pos + c * chunk], axis=1)
        neg, sel = jax.lax.top_k(-all_d, k)
        return (-neg, jnp.take_along_axis(all_i, sel, axis=1)), None

    init = (
        jnp.full((B, k), jnp.inf, jnp.float32),
        jnp.full((B, k), -1, jnp.int32),
    )
    (d, ids), _ = jax.lax.scan(step, init, jnp.arange(n_pad // chunk))
    return pt._merge(d, ids, k, n_pad)


@functools.partial(jax.jit, static_argnames=("k",))
def flat_topk_nosplit(q, x, xn, k: int):
    """``flat_topk`` traced with the corpus split turned off (one split).
    A function of its own, so that jit traces it apart from ``flat_topk``."""
    keep = pt.TARGET_PROGRAMS
    pt.TARGET_PROGRAMS = 1
    try:
        return pt.flat_topk.__wrapped__(q, x, xn, k=k)
    finally:
        pt.TARGET_PROGRAMS = keep


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _corpus(key, n, d, dtype):
    x = jax.random.normal(key, (n, d), jnp.float32)
    if dtype == jnp.int8:
        scale = 127.0 / jnp.max(jnp.abs(x))
        xs = jnp.clip(jnp.round(x * scale), -127, 127).astype(jnp.int8)
    else:
        xs = x.astype(jnp.bfloat16)
    n_pad = n + (-n) % pt.ROW_ALIGN
    xs = jnp.pad(xs, ((0, n_pad - n), (0, 0)))
    xf = xs.astype(jnp.float32)
    norms = jnp.where(
        jnp.arange(n_pad) < n, jnp.sum(xf * xf, axis=1), jnp.inf
    )
    return xs, norms, scale if dtype == jnp.int8 else None


def _queries(key, B, d, dtype, scale):
    q = jax.random.normal(key, (B, d), jnp.float32)
    if dtype == jnp.int8:
        return jnp.clip(jnp.round(q * scale), -127, 127).astype(jnp.int8)
    return q


def _time(fn, reps):
    jax.block_until_ready(fn(0))  # compile
    ts = []
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r + 1))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    name = card()
    print("card:", name, flush=True)
    d = 128
    rows = []
    for label, B, k, dtype in [
        ("serve_bf16", 16384, 10, jnp.bfloat16),
        ("serve_i8", 16384, 10, jnp.int8),
        ("build_bf16", 4096, 128, jnp.bfloat16),
        ("serve_bf16_small", 256, 10, jnp.bfloat16),
    ]:
        xs, xn, scale = _corpus(jax.random.PRNGKey(1), a.n, d, dtype)
        qkeys = [jax.random.PRNGKey(100 + r) for r in range(a.reps + 1)]
        qs = [_queries(kk, B, d, dtype, scale) for kk in qkeys]
        ik, dk = pt.flat_topk(qs[0], xs, xn, k=k)
        ip, dp = flat_topk_plain(qs[0], xs, xn, k=k)
        ik, ip = np.asarray(ik), np.asarray(ip)
        agree = float(np.mean(
            [len(set(u) & set(v)) / k for u, v in zip(ik[:512], ip[:512])]
        ))
        dmax = float(jnp.max(jnp.abs(dk - dp) / (jnp.abs(dp) + 1.0)))
        t_kernel = _time(lambda r: pt.flat_topk(qs[r], xs, xn, k=k), a.reps)
        t_plain = _time(
            lambda r: flat_topk_plain(qs[r], xs, xn, k=k), a.reps
        )
        row = {
            "shape": label, "B": B, "N": a.n, "d": d, "k": k,
            "kernel_s": t_kernel, "plain_s": t_plain,
            "kernel_qps": B / t_kernel, "plain_qps": B / t_plain,
            "id_agreement": agree, "max_rel_d_diff": dmax, "card": name,
        }
        if B <= 4096:
            row["kernel_nosplit_s"] = _time(
                lambda r: flat_topk_nosplit(qs[r], xs, xn, k=k), a.reps
            )
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
