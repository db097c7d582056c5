"""Apply the two-pass refinement to a saved index and save the result.

The wave builder's early nodes only ever saw a small prefix of the
corpus;
`models/wavebuild.refine_index_wave` re-runs their insert search against
the FINAL graph.  This tool refines a saved index npz so the A/B is two
`tools/bench_1m.py --skip-build --idx <file>` serving runs over the same
corpus and ground truth.

Usage:
  python tools/refine_1m.py --idx index/bench_1m_idx_M48_clustered.npz \
      --out index/bench_1m_idx_M48_clustered_refined.npz \
      --M 48 --efc 300 [--frac 0.5] [--wave 4096]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--idx", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--M", type=int, required=True)
    ap.add_argument("--efc", type=int, required=True)
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--wave", type=int, default=4096)
    ap.add_argument("--refine-ef", type=int, default=0)
    args = ap.parse_args()

    from expann_tpu.models.build import BuildConfig
    from expann_tpu.models.wavebuild import refine_index_wave
    from expann_tpu.utils.persist import load_index, save_index

    graph, meta = load_index(args.idx)
    print(f"loaded {args.idx}: n={graph.n} R0={graph.adj_bottom.shape[1]}",
          flush=True)
    cfg = BuildConfig(
        M=args.M, ef_construction=args.efc, prune_cand=args.efc,
        precision="default",
    )
    t0 = time.perf_counter()
    refined = refine_index_wave(
        graph, cfg, frac=args.frac, wave_size=args.wave,
        refine_ef=args.refine_ef, verbose=True,
    )
    dt = time.perf_counter() - t0
    print(f"refine: {dt:.0f}s (frac={args.frac}, wave={args.wave})",
          flush=True)
    save_index(args.out, refined, dict(meta))
    print(f"saved {args.out}", flush=True)


if __name__ == "__main__":
    main()
