"""GPU smoke run of the main path at SIFT1M scale, in one process.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: the mesh paths only

Corpus: SIFT1M's shape (N = 1,000,000, d = 128, u8-valued clustered
floats, 10,000 queries), generated in memory from ``--seed``
(expann_tpu.data.loader.generate_sift_like).  Nothing is downloaded.

Phases, one line each (every time is printed beside the card's name and
power limit):

  1. device   the default JAX device must be a GPU; prints its kind, the
              device count and ``nvidia-smi``'s name and power limit.
  2. oracle   BruteForceEngine(mode="exact", precision="highest") gives the
              ground truth of 1,000 queries; checked against float64 numpy
              on 64 of them (ids equal up to exact ties, |Δd²| <= 1e-4 ·
              (|q|² + |x|²)).
  3. kernel   the flat_topk kernel, compiled for the card, against float64
              numpy on 1,024 queries x 1M rows at k = 10 and k = 128, bf16
              and int8 (int8 after the f32 rerank at "highest").
  4. flat     BruteForceEngine store -> build -> query_k_batch on 16,384-
              query batches, bf16 and int8: recall@10 >= 0.98, build s, QPS.
  5. graph    AntitopoEngine(M=48, M0=96, ef_construction=300,
              prune_overflow=1) built through builder="auto" (the
              distributed builder: incremental waves, flat-scan
              candidates), cold and warm; query_k_batch at ef 64 and 128:
              recall@10 at ef=128 >= 0.90, QPS.
  6. cli      expann_tpu.cli.main on config_synthetic.json (the reference's
              canonical 56k config): 24 records, uncompressed max recall
              >= 0.85 (see CLI_RECALL).

``--four`` runs, on the same corpus over ``make_mesh(4)`` (a 1-D mesh; the
cards are joined all to all): build_sharded + sharded_query_batch,
replicated_query_dp, sharded_flat_query and build_distributed +
query_batch, each against the exact oracle with the floors above.

A failed check raises; the script then exits non-zero and prints no
result.  The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--trace DIR`` also records a profiler trace of one graph query batch
and writes its per-kernel summary to DIR/beam_trace.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N, D, M_QUERIES = 1_000_000, 128, 10_000
ORACLE_Q, KERNEL_Q, CHECK_Q = 1000, 1024, 64
FLAT_BATCH = 16384
GRAPH = dict(M=48, M0=96, ef_construction=300, prune_overflow=1)
EFS = (64, 128)
FLAT_RECALL, GRAPH_RECALL = 0.98, 0.90
# The canonical grid's widest beam is ef = 6k = 60, where this algorithm
# sits near 0.88 on the 56k Gaussian config (the single-core C++ loop of
# BASELINE.md: 0.83 at ef=45, 0.94 at ef=90), so 0.99 is out of reach there.
CLI_RECALL = 0.85


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, read by a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def require_gpu(devices) -> dict:
    d = devices[0]
    check(d.platform == "gpu", f"needs a GPU, JAX found {d.platform!r}")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}


def recall_at(ans: np.ndarray, gt: np.ndarray, k: int = 10) -> float:
    hits = sum(
        len(set(a[:k].tolist()) & set(g[:k].tolist())) for a, g in zip(ans, gt)
    )
    return hits / (len(gt) * k)


# ---------------------------------------------------------------------------
# float64 reference on the host
# ---------------------------------------------------------------------------


def exact_f64(q: np.ndarray, x: np.ndarray, k: int, chunk: int = 65536):
    """Exact top-k in float64: (ids, d2), ascending by (d2, id)."""
    q64 = q.astype(np.float64)
    qn = (q64 * q64).sum(1)
    best_d = np.full((q.shape[0], 0), np.inf)
    best_i = np.zeros((q.shape[0], 0), np.int64)
    for s in range(0, x.shape[0], chunk):
        xc = x[s : s + chunk].astype(np.float64)
        d2 = qn[:, None] + (xc * xc).sum(1)[None, :] - 2.0 * (q64 @ xc.T)
        kk = min(k, d2.shape[1])
        part = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
        best_d = np.concatenate([best_d, np.take_along_axis(d2, part, 1)], 1)
        best_i = np.concatenate([best_i, part + s], 1)
    order = np.lexsort((best_i, best_d), axis=1)[:, :k]
    return np.take_along_axis(best_i, order, 1), np.take_along_axis(best_d, order, 1)


def d2_f64(q: np.ndarray, x: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """float64 squared distances of q[b] to x[ids[b, j]]."""
    diff = x[ids].astype(np.float64) - q[:, None, :].astype(np.float64)
    return (diff * diff).sum(-1)


def scale_of(q: np.ndarray, x: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """|q|² + |x|² for each returned pair (the tolerance unit)."""
    qn = (q.astype(np.float64) ** 2).sum(1)[:, None]
    xn = (x.astype(np.float64) ** 2).sum(1)[ids]
    return qn + xn


def check_ranked(q, x, ids, ref_d, tol, what: str) -> float:
    """ids equal to the reference up to exact ties: the true distance of
    each returned id matches the true distance at that rank, within
    ``tol`` · (|q|² + |x|²).  Returns the largest relative gap."""
    got = d2_f64(q, x, ids)
    rel = np.abs(got - ref_d) / scale_of(q, x, ids)
    check(float(rel.max()) <= tol, f"{what}: rank distance gap {rel.max():.3g} > {tol}")
    return float(rel.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_oracle(x, q, oracle_q=ORACLE_Q, check_q=CHECK_Q):
    """Exact ground truth on the device; checked against float64."""
    import jax.numpy as jnp

    from expann_tpu.models.brute_force import BruteForceEngine, _exact_topk

    t0 = time.perf_counter()
    eng = BruteForceEngine(mode="exact", precision="highest", batch_size=1024)
    eng.store_many_vectors(x)
    eng.build()
    gt = eng.query_k_batch(q[:oracle_q], 128)
    seconds = time.perf_counter() - t0

    qc = eng._x.shape[1]
    qp = np.zeros((check_q, qc), np.float32)
    qp[:, : x.shape[1]] = q[:check_q]
    ids, dd = _exact_topk(jnp.asarray(qp), eng._x, eng._x_norms, 10, "highest")
    ids, dd = np.asarray(ids), np.asarray(dd).astype(np.float64)
    ref_i, ref_d = exact_f64(q[:check_q], x, 10)
    gap = check_ranked(q[:check_q], x, ids, ref_d, 0.0, "oracle ids")
    dgap = float(
        (np.abs(dd - d2_f64(q[:check_q], x, ids)) / scale_of(q[:check_q], x, ids)).max()
    )
    check(dgap <= 1e-4, f"oracle distances off by {dgap:.3g}")
    del eng
    return gt, {"seconds": seconds, "ids_rank_gap": gap, "d2_rel_err": dgap}


def phase_kernel(x, q, n_q=KERNEL_Q):
    """flat_topk (compiled on the card) against float64 at real widths."""
    import jax.numpy as jnp

    from expann_tpu.models.brute_force import _rerank_exact
    from expann_tpu.ops.distance import pad_dim
    from expann_tpu.ops.pallas_topk import flat_topk, prepare_corpus, quantize_query_i8

    qs = q[:n_q]
    ref_i, ref_d = exact_f64(qs, x, 128)
    xp = pad_dim(x)
    x_dev = jnp.asarray(xp)
    x_norms = jnp.sum(x_dev * x_dev, axis=1)
    out = {}
    for dtype, label in ((jnp.bfloat16, "bf16"), (jnp.int8, "i8")):
        corpus = prepare_corpus(xp, dtype)
        for k in (10, 128):
            if dtype == jnp.int8:
                qk = jnp.asarray(quantize_query_i8(pad_dim(qs), corpus.center, corpus.scale))
                scan_k = min(3 * k, 128)
            else:
                qk = jnp.asarray(pad_dim(qs))
                scan_k = k
            t0 = time.perf_counter()
            ids, dd = flat_topk(qk, corpus.x, corpus.norms, k=scan_k)
            ids.block_until_ready()
            first_s = time.perf_counter() - t0
            if dtype == jnp.int8:
                # an f32 matmul at precision="default" runs in TF32 on this
                # card (ops/distance.py), so the exact rerank is "highest"
                ids, dd = _rerank_exact(
                    jnp.asarray(pad_dim(qs)), x_dev, x_norms, ids, k=k,
                    precision="highest",
                )
                tol = 1e-4
            else:
                tol = 2.0**-7  # bf16 rounding of the inputs
            ids = np.asarray(ids)[:, :k]
            dd = np.asarray(dd)[:, :k].astype(np.float64)
            check(((ids >= 0) & (ids < x.shape[0])).all(), f"{label} k={k}: ids out of range")
            ov = recall_at(ids, ref_i, 10)
            check(ov >= 0.99, f"{label} k={k}: top-10 overlap {ov:.4f} < 0.99")
            true_d = d2_f64(qs, x, ids)
            rel = float((np.abs(dd - true_d) / scale_of(qs, x, ids)).max())
            check(rel <= tol, f"{label} k={k}: d2 error {rel:.3g} > {tol:.3g}")
            out[f"{label}_k{k}"] = {
                "top10_overlap": ov,
                "topk_overlap": recall_at(ids, ref_i, k),
                "d2_rel_err": rel,
                "first_call_s": first_s,
            }
        del corpus
    return out


def _timed_batches(eng, qbatches, k):
    eng.query_k_batch(qbatches[0], k)  # compile
    ts = []
    for b in qbatches:
        t0 = time.perf_counter()
        eng.query_k_batch(b, k)
        ts.append(time.perf_counter() - t0)
    return qbatches[0].shape[0] / float(np.median(ts)), ts


def phase_flat(x, q, gt, qbatches):
    from expann_tpu.models.brute_force import BruteForceEngine

    out = {}
    for mode in ("fused", "fused_i8"):
        eng = BruteForceEngine(mode=mode)
        eng.store_many_vectors(x)
        t0 = time.perf_counter()
        eng.build()
        build_s = time.perf_counter() - t0
        rec = recall_at(eng.query_k_batch(q[: len(gt)], 10), gt)
        check(rec >= FLAT_RECALL, f"flat {mode}: recall@10 {rec:.4f} < {FLAT_RECALL}")
        qps, ts = _timed_batches(eng, qbatches, 10)
        out[mode] = {"recall@10": rec, "build_s": build_s, "qps": qps,
                     "batch": qbatches[0].shape[0], "batch_s": ts}
        del eng
    return out


def graph_config(efc: int):
    from expann_tpu.models.antitopo import AntitopoConfig

    return AntitopoConfig(**{**GRAPH, "ef_construction": efc})


def phase_graph(x, q, gt, efc: int = GRAPH["ef_construction"], trace_dir: str = ""):
    from expann_tpu.models.antitopo import AntitopoEngine

    builds = {}
    eng = None
    for label in ("cold", "warm"):
        eng = AntitopoEngine(config=graph_config(efc))
        eng.store_many_vectors(x)
        t0 = time.perf_counter()
        eng.build()
        builds[f"build_{label}_s"] = time.perf_counter() - t0
    out = dict(builds, ef_construction=efc, builder=eng.cfg.builder)
    for ef in EFS:
        eng.set_ef_search(ef)
        rec = recall_at(eng.query_k_batch(q[: len(gt)], 10), gt)
        eng.query_k_batch(q, 10)  # compile the full-batch shapes
        t0 = time.perf_counter()
        eng.query_k_batch(q, 10)
        out[f"ef{ef}"] = {"recall@10": rec, "qps": len(q) / (time.perf_counter() - t0)}
    rec = out[f"ef{EFS[-1]}"]["recall@10"]
    check(rec >= GRAPH_RECALL, f"graph: recall@10 at ef={EFS[-1]} {rec:.4f} < {GRAPH_RECALL}")
    if trace_dir:
        out["trace"] = trace_beam(eng, q, trace_dir)
    return out


def trace_beam(eng, q, trace_dir: str) -> dict:
    """Profile one query batch (1,024 queries at the last ef) and sum the
    device time per kernel name; writes DIR/beam_trace.json."""
    import glob

    import jax

    qb = q[: eng.cfg.query_block]
    eng.query_k_batch(qb, 10)
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        eng.query_k_batch(qb, 10)
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    per_name, busy, first, last = {}, 0, None, None
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                per_name.setdefault(ev.name, [0, 0])
                per_name[ev.name][0] += ev.duration_ns
                per_name[ev.name][1] += 1
                busy += ev.duration_ns
                first = ev.start_ns if first is None else min(first, ev.start_ns)
                end = ev.start_ns + ev.duration_ns
                last = end if last is None else max(last, end)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:40]
    groups = {"gather": 0, "sort": 0, "dot": 0, "other": 0}
    for name, (ns, _) in per_name.items():
        low = name.lower()
        key = ("gather" if "gather" in low else "sort" if "sort" in low
               else "dot" if ("gemm" in low or "dot" in low or "cublas" in low) else "other")
        groups[key] += ns
    summary = {
        "queries": len(qb), "ef": eng.cfg.ef_search, "wall_s": wall,
        "device_busy_s": busy * 1e-9,
        "device_span_s": (last - first) * 1e-9 if first is not None else 0.0,
        "share": {k: v / busy for k, v in groups.items()} if busy else {},
        "kernels": [{"name": n, "ms": ns * 1e-6, "count": c} for n, (ns, c) in top],
    }
    with open(os.path.join(trace_dir, "beam_trace.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return {k: summary[k] for k in ("wall_s", "device_busy_s", "device_span_s", "share")}


def phase_cli(workdir: str, config: str = os.path.join(REPO, "config_synthetic.json")):
    """The benchmark CLI on the reference's canonical 56k config, run in a
    fresh working directory (it writes data/ and index/ under the cwd)."""
    from expann_tpu.cli import main as cli_main

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    here = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        rc = cli_main(["--config", config, "--ds_name", "chip_smoke_cli"])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"cli returned {rc}")
        with open(os.path.join("data", "chip_smoke_cli", "data", "latest.json")) as f:
            records = json.load(f)
    finally:
        os.chdir(here)
    check(len(records) == 24, f"cli wrote {len(records)} records, expected 24")
    check(all(isinstance(r, dict) for r in records), "cli: a job failed")
    plain = [r["recall"] for r in records if r["param_list"]["use_compression"] in ("0", "false")]
    check(len(plain) == 12, f"cli: {len(plain)} uncompressed records")
    check(max(plain) >= CLI_RECALL, f"cli: max uncompressed recall {max(plain):.4f} < {CLI_RECALL}")
    return {"records": len(records), "max_recall_uncompressed": max(plain), "seconds": seconds}


def phase_four(x, q, gt, efc: int = GRAPH["ef_construction"]):
    """The mesh paths over four devices, each against the exact oracle."""
    import jax.numpy as jnp

    from expann_tpu.models.search import query_batch
    from expann_tpu.ops.distance import pad_dim
    from expann_tpu.parallel.distbuild import build_distributed
    from expann_tpu.parallel.sharded import (
        build_sharded,
        build_sharded_flat,
        make_mesh,
        replicated_query_dp,
        sharded_flat_query,
        sharded_query_batch,
    )

    from expann_tpu.models.antitopo import AntitopoEngine

    mesh = make_mesh(4)
    bcfg = AntitopoEngine(config=graph_config(efc))._build_config()
    qg = q[: len(gt)]
    ef = EFS[-1]
    out = {}

    t0 = time.perf_counter()
    flat = build_sharded_flat(x, mesh)
    rec = recall_at(sharded_flat_query(flat, qg, 10), gt)
    out["sharded_flat"] = {"recall@10": rec, "seconds": time.perf_counter() - t0}
    check(rec >= FLAT_RECALL, f"sharded_flat_query: recall@10 {rec:.4f}")
    del flat

    t0 = time.perf_counter()
    graph, stats = build_distributed(x, bcfg, mesh, wave_size=4096, mode="incremental")
    build_s = time.perf_counter() - t0
    ids, _, _ = query_batch(graph, jnp.asarray(pad_dim(qg)), k=10, ef=ef)
    rec = recall_at(np.asarray(ids), gt)
    out["build_distributed"] = {"recall@10": rec, "build_s": build_s,
                                "candidates": stats["candidates"]}
    check(rec >= GRAPH_RECALL, f"build_distributed + query_batch: recall@10 {rec:.4f}")

    t0 = time.perf_counter()
    rec = recall_at(replicated_query_dp(graph, qg, k=10, ef=ef, mesh=mesh), gt)
    out["replicated_query_dp"] = {"recall@10": rec, "seconds": time.perf_counter() - t0}
    check(rec >= GRAPH_RECALL, f"replicated_query_dp: recall@10 {rec:.4f}")
    del graph

    t0 = time.perf_counter()
    index = build_sharded(x, bcfg, mesh)
    build_s = time.perf_counter() - t0
    rec = recall_at(sharded_query_batch(index, qg, k=10, ef=ef), gt)
    out["build_sharded"] = {"recall@10": rec, "build_s": build_s}
    check(rec >= GRAPH_RECALL, f"build_sharded + sharded_query_batch: recall@10 {rec:.4f}")
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--four", action="store_true", help="run only the four-GPU mesh paths")
    ap.add_argument("--trace", default="", help="write a beam-search trace summary here")
    a = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    import expann_tpu  # noqa: F401  (configures the compile cache)

    dev = require_gpu(jax.devices())
    card = card_line()
    if a.four:
        check(dev["count"] == 4, f"--four needs 4 GPUs, found {dev['count']}")
    say("device", kind=dev["kind"], count=dev["count"], card=card)

    from expann_tpu.data.loader import generate_sift_like

    t0 = time.perf_counter()
    extra = 0 if a.four else 3 * FLAT_BATCH
    x, q_all = generate_sift_like(N, M_QUERIES + extra, D, seed=a.seed)
    q, q_more = q_all[:M_QUERIES], q_all[M_QUERIES:]
    say("data", n=N, d=D, queries=M_QUERIES, seconds=time.perf_counter() - t0, card=card)

    gt, info = phase_oracle(x, q)
    say("oracle", card=card, **info)

    if a.four:
        say("four", card=card, **phase_four(x, q, gt))
    else:
        say("kernel", card=card, **phase_kernel(x, q))
        qbatches = [q_more[i * FLAT_BATCH : (i + 1) * FLAT_BATCH] for i in range(3)]
        say("flat", card=card, **phase_flat(x, q, gt, qbatches))
        say("graph", card=card, **phase_graph(x, q, gt, trace_dir=a.trace))
        say("cli", card=card, **phase_cli(os.path.join(REPO, ".smoke_run")))
        shutil.rmtree(os.path.join(REPO, ".smoke_run"), ignore_errors=True)
    print(card)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
