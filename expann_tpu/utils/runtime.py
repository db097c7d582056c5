"""Process-wide JAX runtime configuration and the one backend decision.

``configure()`` enables the persistent compilation cache so index builds and
query kernels compile once per machine instead of once per process.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing here
overrides it; otherwise the cache lives at ``<repo>/.jax_cache`` (a fixed
path: the path is part of the cache key).  ``EXPANN_NO_CACHE=1`` disables
it (the CPU test suite does).

``pallas_interpret()`` is the only place that decides how a Pallas kernel
runs: compiled on a GPU, in the Pallas interpreter on the CPU (the test
platform), and refused anywhere else.
"""

from __future__ import annotations

import os

import jax

_configured = False

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    if os.environ.get("EXPANN_NO_CACHE") == "1":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def platform() -> str:
    """Platform of the default backend ("gpu", "cpu", ...)."""
    return jax.default_backend()


def pallas_interpret() -> bool:
    """Whether Pallas kernels run in the interpreter on this platform.

    "gpu": False, the kernels compile (Triton route).  "cpu": True, the
    interpreter runs them (tests and tiny rehearsals only).  Any other
    platform raises: the kernels were written for neither.
    """
    p = platform()
    if p == "gpu":
        return False
    if p == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernel path for platform {p!r}: expected 'gpu' (compiled) "
        "or 'cpu' (interpreter)"
    )
