"""Dataset loaders: synthetic Gaussian + SIFT1M fvecs/ivecs.

Counterpart of the reference dataset_loader (reference:
src/dataset_loader.h): synthetic N(0,1) vectors with brute-force ground
truth cached to JSON keyed by (n, dim, m, k) (:10-95), and the fvecs/ivecs
binary readers for SIFT1M (:96-182).  Ground truth here comes from the
device brute-force engine (one matmul + top-k) instead of a scalar heap scan.

The fvecs/ivecs hot parser prefers the native C++ loader
(native/expann_io.cpp via ctypes) and falls back to a numpy implementation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from expann_tpu.data.dataset import TestDataset


def read_vecs(filename: str, dtype=np.float32) -> np.ndarray:
    """Read an fvecs/ivecs file: each record is (int32 d, d * 4-byte items)
    (reference: src/dataset_loader.h:96-125)."""
    try:
        from expann_tpu.utils.io_native import native_read_vecs

        arr = native_read_vecs(filename, dtype)
        if arr is not None:
            return arr
    except Exception:
        pass
    raw = np.fromfile(filename, dtype=np.int32)
    if raw.size == 0:
        raise IOError(f"empty vecs file: {filename}")
    d = int(raw[0])
    rec = d + 1
    if raw.size % rec != 0:
        raise IOError(f"corrupt vecs file: {filename}")
    mat = raw.reshape(-1, rec)[:, 1:]
    if dtype == np.float32:
        mat = mat.view(np.float32)
    return np.ascontiguousarray(mat.astype(dtype))


def generate_synthetic(
    n: int, m: int, d: int, seed: Optional[int] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Per-coordinate N(0,1) vectors, rejecting near-zero norms
    (reference: src/randomgeometry.h:73-96 vec_generator).  The reference
    seeds from std::random_device (non-deterministic); we default to a
    fixed seed for reproducible benchmarks."""
    rng = np.random.default_rng(42 if seed is None else seed)
    eps = 1e-7
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((m, d)).astype(np.float32)
    for arr in (vecs, queries):
        while True:
            bad = np.einsum("ij,ij->i", arr, arr) < eps
            if not bad.any():
                break
            arr[bad] = rng.standard_normal((int(bad.sum()), d)).astype(np.float32)
    return vecs, queries


def generate_synthetic_clustered(
    n: int,
    m: int,
    d: int,
    n_clusters: int = 1000,
    sigma: float = 0.3,
    seed: Optional[int] = None,
    uniform: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Mixture-of-Gaussians synthetic data modeling the LOW intrinsic
    dimension of real ANN corpora (SIFT1M: ~15).  No reference counterpart
    (its synthetic generator is isotropic Gaussian,
    src/randomgeometry.h:73-96); isotropic Gaussian d=128 at N=1e6 is a
    curse-of-dimensionality regime where every graph method degrades.

    Deliberately NOT flattering to graph search (a harder stand-in than
    equal isotropic clusters):

      * cluster masses are Zipf-ish (``(rank + 3)^-0.6``) — some clusters
        hold ~30x the mass of others, like real corpora,
      * per-cluster ANISOTROPY: each cluster's spread is scaled per-axis
        by lognormal factors (sigma_eff in ~[sigma/3, 3*sigma]), so local
        neighbourhood geometry varies across the corpus,
      * per-cluster overall scale also varies (lognormal), producing both
        tight and diffuse regions,
      * queries are drawn from the SAME mixture but with 1.5x the
        within-cluster spread, so queries are NOT near-corpus-points
        (SIFT queries are held-out images, not corpus perturbations), and
        a 10% slice is drawn from between-cluster interpolations (off-mode
        queries with no dominant basin).

    ``uniform=True`` gives the equal-mass isotropic variant."""
    rng = np.random.default_rng(42 if seed is None else seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    if uniform:

        def draw(count, spread=1.0):
            which = rng.integers(0, n_clusters, size=count)
            return (
                centers[which]
                + sigma * rng.standard_normal((count, d)).astype(np.float32)
            ).astype(np.float32)

        return draw(n), draw(m)

    # Zipf-ish masses, anisotropic per-axis scales, per-cluster size factor
    mass = (np.arange(n_clusters) + 3.0) ** -0.6
    mass = mass / mass.sum()
    axis_scale = np.exp(
        rng.normal(0.0, 0.45, size=(n_clusters, d))
    ).astype(np.float32)
    clus_scale = np.exp(rng.normal(0.0, 0.35, size=(n_clusters, 1))).astype(
        np.float32
    )

    def draw(count, spread=1.0):
        which = rng.choice(n_clusters, size=count, p=mass)
        noise = rng.standard_normal((count, d)).astype(np.float32)
        return (
            centers[which]
            + sigma
            * spread
            * clus_scale[which]
            * axis_scale[which]
            * noise
        ).astype(np.float32)

    vecs = draw(n)
    m_mix = m // 10
    q_main = draw(m - m_mix, spread=1.5)
    # between-cluster interpolations: no dominant basin
    a = rng.integers(0, n_clusters, size=m_mix)
    b = rng.integers(0, n_clusters, size=m_mix)
    t = rng.uniform(0.25, 0.75, size=(m_mix, 1)).astype(np.float32)
    q_between = (
        centers[a] * t
        + centers[b] * (1.0 - t)
        + sigma * rng.standard_normal((m_mix, d)).astype(np.float32)
    ).astype(np.float32)
    queries = np.concatenate([q_main, q_between], axis=0)
    return vecs, queries


def to_u8_box(
    x: np.ndarray, lo_q: float = 0.001, hi_q: float = 0.999, bounds=None
) -> tuple[np.ndarray, tuple]:
    """Affine-map a float cloud into integer-valued [0, 255] (SIFT's value
    regime: fvecs files of real SIFT hold u8 descriptors promoted to
    float).  Returns (u8-valued f32 array, bounds) — pass the returned
    bounds back in so queries share the corpus transform."""
    if bounds is None:
        # quantiles of a strided sample: exact enough for a clip range,
        # and a full-corpus quantile would sort 128M values
        flat = x.reshape(-1)
        sample = flat[:: max(1, flat.size // 4_000_000)]
        bounds = (
            float(np.quantile(sample, lo_q)),
            float(np.quantile(sample, hi_q)),
        )
    lo, hi = bounds
    y = (x - lo) * (255.0 / max(hi - lo, 1e-9))
    return np.clip(np.rint(y), 0, 255).astype(np.float32), bounds


def generate_sift_like(
    n: int, m: int, d: int = 128, seed: int = 7
) -> tuple[np.ndarray, np.ndarray]:
    """A SIFT1M-shaped corpus and query set (SIFT1M: n=1,000,000, m=10,000,
    d=128, reference src/main.cpp:72-80): clustered geometry
    (``generate_synthetic_clustered``) mapped into SIFT's u8-valued box,
    queries through the corpus's own transform."""
    x, q = generate_synthetic_clustered(n, m, d, seed=seed)
    x, bounds = to_u8_box(x)
    q, _ = to_u8_box(q, bounds=bounds)
    return x, q


def load_synthetic_uniform_sphere_points(
    n: int,
    m: int,
    k: int,
    d: int,
    cache_dir: str = "./data",
    seed: Optional[int] = None,
) -> TestDataset:
    """Synthetic Gaussian dataset with exact ground truth, JSON-cached by
    parameters (reference: src/dataset_loader.h:77-95; same cache filename
    scheme, including the reference's original field order)."""
    name = f"synthetic_uniform_sphere_n{n}_dim{d}_m{m}_k{k}"
    filename = os.path.join(cache_dir, name + ".dataset")
    if os.path.exists(filename):
        return TestDataset.load_json(filename)

    vecs, queries = generate_synthetic(n, m, d, seed)

    from expann_tpu.models.brute_force import BruteForceEngine

    eng = BruteForceEngine()
    eng.store_many_vectors(vecs)
    eng.build()
    gt = eng.query_k_batch(queries, k).astype(np.int64)

    ds = TestDataset(name=name, vecs=vecs, queries=queries, ground_truth=gt)
    try:
        ds.save_json(filename)
    except OSError:
        pass
    return ds


def load_sift1m(
    filename_base: str,
    filename_query: str,
    filename_groundtruth: str,
    k_custom: int = 100,
) -> TestDataset:
    """SIFT1M from fvecs/ivecs files; ground truth truncated to k_custom
    (reference: src/dataset_loader.h:127-168)."""
    base = read_vecs(filename_base, np.float32)
    query = read_vecs(filename_query, np.float32)
    gt = read_vecs(filename_groundtruth, np.int64)
    k = min(k_custom, gt.shape[1])
    gt = gt[:, :k]
    name = f"sift1m_full_k{k}"
    return TestDataset(name=name, vecs=base, queries=query, ground_truth=gt)


def load_sift1m_custom(
    filename_base: str,
    filename_query: str,
    filename_groundtruth: str,
    k_custom: int = 100,
    m_custom: int = 2,
) -> TestDataset:
    """SIFT1M with a truncated query set for quick runs
    (reference: src/dataset_loader.h:169-182)."""
    ds = load_sift1m(filename_base, filename_query, filename_groundtruth, k_custom)
    m = min(m_custom, ds.m)
    return TestDataset(
        name=ds.name + f"_m{m}",
        vecs=ds.vecs,
        queries=ds.queries[:m],
        ground_truth=ds.ground_truth[:m],
    )
