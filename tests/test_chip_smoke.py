"""chip_smoke.py: its refusal off the GPU, and its phases at tiny size on
the CPU (Pallas in the interpreter) through their own functions."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from expann_tpu.data.loader import generate_sift_like  # noqa: E402


@pytest.fixture(scope="module")
def data():
    x, q = generate_sift_like(6000, 200, 32, seed=3)
    gt, info = chip_smoke.phase_oracle(x, q, oracle_q=100, check_q=16)
    return x, q, gt, info


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_main_refuses_cpu_platform():
    with pytest.raises(AssertionError, match="needs a GPU"):
        chip_smoke.main([])


def test_script_exits_nonzero_without_gpu_and_prints_no_result():
    r = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize(
    "platform,ok", [("gpu", True), ("cpu", False), ("metal", False)]
)
def test_require_gpu(platform, ok):
    devs = [types.SimpleNamespace(platform=platform, device_kind="X")] * 2
    if ok:
        assert chip_smoke.require_gpu(devs) == {
            "platform": "gpu", "kind": "X", "count": 2,
        }
    else:
        with pytest.raises(AssertionError):
            chip_smoke.require_gpu(devs)


def test_exact_f64_matches_sort():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (3000, 16)).astype(np.float32)
    q = rng.integers(0, 255, (20, 16)).astype(np.float32)
    ids, d = chip_smoke.exact_f64(q, x, 25, chunk=700)
    full = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(d, np.sort(full, axis=1)[:, :25])
    np.testing.assert_array_equal(np.take_along_axis(full, ids, 1), d)


def test_phase_oracle(data):
    _, _, gt, info = data
    assert gt.shape == (100, 128)
    assert info["ids_rank_gap"] == 0.0 and info["d2_rel_err"] <= 1e-4


def test_phase_kernel(data):
    x, q, _, _ = data
    out = chip_smoke.phase_kernel(x, q, n_q=64)
    assert set(out) == {"bf16_k10", "bf16_k128", "i8_k10", "i8_k128"}
    assert all(v["top10_overlap"] >= 0.99 for v in out.values())


def test_phase_flat(data):
    x, q, gt, _ = data
    out = chip_smoke.phase_flat(x, q, gt, [q[:64], q[64:128]])
    for mode in ("fused", "fused_i8"):
        assert out[mode]["recall@10"] >= chip_smoke.FLAT_RECALL


def test_phase_graph(data, tmp_path):
    x, q, gt, _ = data
    out = chip_smoke.phase_graph(x, q, gt, efc=64, trace_dir=str(tmp_path))
    assert out["ef128"]["recall@10"] >= chip_smoke.GRAPH_RECALL
    assert out["build_cold_s"] > 0 and out["build_warm_s"] > 0
    summary = json.load(open(tmp_path / "beam_trace.json"))
    assert summary["queries"] > 0


def test_phase_four_on_cpu_mesh(data):
    x, q, gt, _ = data
    out = chip_smoke.phase_four(x, q, gt, efc=64)
    assert set(out) == {
        "sharded_flat", "build_distributed", "replicated_query_dp",
        "build_sharded",
    }


def test_phase_cli(tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(
        {"dataset": "Synthetic", "n": 800, "m": 20, "d": 16, "k": 10}
    ))
    out = chip_smoke.phase_cli(str(tmp_path / "run"), config=str(cfg))
    assert out["records"] == 24
