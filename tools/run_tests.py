"""Flake-hardened test runner.

This host's XLA:CPU backend can (rarely) SEGFAULT the test process inside
``backend_compile_and_load`` — observed 2026-08-19 in ``test_wavebuild``
with the compile cache off; the same file passes on immediate rerun
(CLAUDE.md "Environment quirks").  A plain ``pytest tests/`` run dies with
exit 139 and a CI/driver consumer sees a failed round for a known host
flake.

This runner isolates the suite per FILE in subprocesses and retries a file
once when it exits with a crash signal (SIGSEGV/SIGABRT/SIGILL/SIGBUS).
Genuine test FAILURES (pytest rc 1) are never retried — only process
crashes are.

Usage:
  python tools/run_tests.py            # whole suite, per-file isolation
  python tools/run_tests.py tests/test_flat_topk.py ...   # subset

Exit code: 0 iff every file ends green (possibly after one crash retry).

Self-test (crash-injection): tests/test_selftest_crash.py is synthesized on
the fly by --selftest: its first run segfaults, its rerun passes —
demonstrating the retry path end to end.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRASH_SIGNALS = {signal.SIGSEGV, signal.SIGABRT, signal.SIGILL, signal.SIGBUS}
CRASH_RCS = {-s.value for s in CRASH_SIGNALS} | {128 + s.value for s in CRASH_SIGNALS}


def run_file(path: str, extra: list[str]) -> int:
    cmd = [sys.executable, "-m", "pytest", path, "-q", *extra]
    return subprocess.run(cmd, cwd=REPO).returncode


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="*")
    ap.add_argument("--selftest", action="store_true",
                    help="inject a crash-once test file and verify the "
                         "retry path recovers it")
    ap.add_argument("--pytest-args", default="",
                    help="extra args passed through to pytest")
    args = ap.parse_args()
    extra = args.pytest_args.split() if args.pytest_args else []

    files = args.files or sorted(
        glob.glob(os.path.join(REPO, "tests", "test_*.py"))
    )

    selftest_file = os.path.join(REPO, "tests", "test_selftest_crash.py")
    selftest_marker = os.path.join(tempfile.gettempdir(), "expann_selftest_crash_marker")
    if args.selftest:
        with open(selftest_file, "w") as f:
            f.write(
                "import ctypes, os\n"
                f"MARKER = {selftest_marker!r}\n"
                "def test_crash_once():\n"
                "    if not os.path.exists(MARKER):\n"
                "        open(MARKER, 'w').close()\n"
                "        ctypes.string_at(0)  # SIGSEGV on first run\n"
            )
        if os.path.exists(selftest_marker):
            os.remove(selftest_marker)
        files = [selftest_file]

    failed: list[str] = []
    t_start = time.perf_counter()
    try:
        for path in files:
            rel = os.path.relpath(path, REPO)
            rc = run_file(path, extra)
            if rc in CRASH_RCS:
                print(f"[run_tests] {rel} crashed (rc={rc}) — known "
                      "XLA:CPU compile flake, retrying once", flush=True)
                rc = run_file(path, extra)
            if rc == 5:  # pytest: no tests collected — not a failure
                rc = 0
            if rc != 0:
                failed.append(f"{rel} (rc={rc})")
    finally:
        if args.selftest:
            for p in (selftest_file, selftest_marker):
                if os.path.exists(p):
                    os.remove(p)

    dt = time.perf_counter() - t_start
    if failed:
        print(f"[run_tests] FAILED in {dt:.0f}s: {', '.join(failed)}")
        return 1
    print(f"[run_tests] all {len(files)} files green in {dt:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
