"""Export a built index + dataset to the flat binary blob consumed by
``native/baseline_search.cpp`` (the measured single-core CPU baseline).

The reference engine cannot be compiled in-image (empty Eigen/pybind11
submodules, no network for Conan), so the baseline denominator is instead
MEASURED by re-implementing its serving loop — greedy upper-layer descent
(reference: src/antitopo_engine.h:854-903) + bottom-layer best-first beam
search (src/antitopo_engine.h:497-688) over the exact same graph this
framework built — as a single-core C++ program on this host's CPU.

Usage:
  python tools/export_baseline.py \
      --index index/idx_56000.npz --out index/baseline_56k.bin

Blob layout (little-endian):
  int32 magic 0x45584142, n, d, r0, num_layers, starting_vertex, m, k
  f32   vectors[(n+1) * d]          (row n = all-zeros sentinel)
  int32 adj_bottom[(n+1) * r0]      (sentinel id = n)
  per layer, TOPMOST FIRST:         (descent order)
    int32 rows, ru
    int32 slot[n+1]                 (global id -> row; sentinel row = rows-1)
    int32 adj[rows * ru]            (global ids, sentinel n)
  f32   queries[m * d]
  int32 gt[m * k]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--dataset",
                    default="data/synthetic_uniform_sphere_"
                            "n56000_dim128_m400_k10.dataset")
    ap.add_argument("--out", default="index/baseline_56k.bin")
    args = ap.parse_args()

    z = np.load(args.index)
    header = json.loads(bytes(z["header"]).decode())
    vectors = np.ascontiguousarray(z["vectors"], dtype=np.float32)
    adj_bottom = np.ascontiguousarray(z["adj_bottom"], dtype=np.int32)
    sv = int(z["starting_vertex"])
    nl = header["num_layers"]
    n = vectors.shape[0] - 1
    d = vectors.shape[1]
    r0 = adj_bottom.shape[1]

    with open(args.dataset) as f:
        ds = json.load(f)
    queries = np.asarray(ds["all_query_vecs"], dtype=np.float32)
    gt = np.asarray(ds["all_query_ans"], dtype=np.int32)
    m, k = gt.shape
    assert queries.shape == (m, d), (queries.shape, m, d)

    with open(args.out, "wb") as f:
        f.write(struct.pack("<8i", 0x45584142, n, d, r0, nl, sv, m, k))
        f.write(vectors.tobytes())
        f.write(adj_bottom.tobytes())
        # persist stores layers bottom-up; the C++ descent wants top-down
        for i in reversed(range(nl)):
            slot = np.ascontiguousarray(z[f"layer{i}_slot"], dtype=np.int32)
            adj = np.ascontiguousarray(z[f"layer{i}_adj"], dtype=np.int32)
            f.write(struct.pack("<2i", adj.shape[0], adj.shape[1]))
            f.write(slot.tobytes())
            f.write(adj.tobytes())
        f.write(queries.tobytes())
        f.write(gt.tobytes())
    print(f"wrote {args.out}: n={n} d={d} r0={r0} layers={nl} "
          f"sv={sv} m={m} k={k} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
