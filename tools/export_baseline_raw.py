"""Export a *graph-free* baseline blob (vectors + queries + ground truth
only) for ``native/baseline_build.cpp``, which builds its own graph with the
reference's insert loop and therefore ignores any stored adjacency.

Same blob format as tools/export_baseline.py with r0 = 0 and num_layers = 0.

Usage:
  python tools/export_baseline_raw.py \
      --dataset data/synthetic_uniform_sphere_n56000_dim128_m400_k10.dataset \
      --out index/baseline_raw_56k.bin
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--dataset",
        default="data/synthetic_uniform_sphere_n56000_dim128_m400_k10.dataset",
    )
    ap.add_argument("--out", default="index/baseline_raw_56k.bin")
    args = ap.parse_args()

    with open(args.dataset) as f:
        ds = json.load(f)
    vecs = np.asarray(ds["all_vecs"], dtype=np.float32)
    queries = np.asarray(ds["all_query_vecs"], dtype=np.float32)
    gt = np.asarray(ds["all_query_ans"], dtype=np.int32)
    n, d = vecs.shape
    m, k = gt.shape
    assert queries.shape == (m, d)
    vecs_s = np.concatenate([vecs, np.zeros((1, d), np.float32)], axis=0)

    with open(args.out, "wb") as f:
        f.write(struct.pack("<8i", 0x45584142, n, d, 0, 0, 0, m, k))
        f.write(vecs_s.tobytes())
        f.write(queries.tobytes())
        f.write(gt.tobytes())
    print(
        f"wrote {args.out}: n={n} d={d} m={m} k={k} "
        f"({os.path.getsize(args.out) / 1e6:.1f} MB)"
    )


if __name__ == "__main__":
    main()
