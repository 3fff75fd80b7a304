"""Structured metrics logging (SURVEY §5 metrics row).

The reference logged with bare print + flush (train.py:187-194) and left TF
summary writers commented out. Here: JSONL to stdout and optionally a file —
machine-parseable, crash-safe (line-buffered)."""

from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, path: str | None = None, also_stdout: bool = True,
                 quiet: bool = False):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1) if path else None
        self._stdout = also_stdout and not quiet  # quiet: non-main hosts
        self._t0 = time.time()

    def log(self, record: dict) -> None:
        record = dict(record, t=round(time.time() - self._t0, 3))
        line = json.dumps(record, sort_keys=True, default=float)
        if self._stdout:
            print(line)
            sys.stdout.flush()
        if self._f:
            self._f.write(line + "\n")

    def close(self):
        if self._f:
            self._f.close()


def profile_trace(log_dir: str):
    """Context manager: capture a jax.profiler trace viewable in Perfetto /
    TensorBoard (SURVEY §5 tracing row)."""
    import jax
    return jax.profiler.trace(log_dir)


# the checkout that holds this package: desire/utils/logging.py -> root
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """Directory of the persistent XLA compilation cache.

    JAX_COMPILATION_CACHE_DIR when it is set (JAX reads that variable
    itself, so no other directory is set in code); otherwise a fixed
    ``.jax_cache/`` at the checkout root (git-ignored) — a fixed path, so
    every later process of this checkout finds what earlier ones compiled."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT_ROOT, ".jax_cache"))


def enable_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Turn on the persistent compilation cache at compile_cache_dir()
    for CLI runs and the test suite (conftest.py): the full model's train
    and K=50 programs take tens of seconds to compile."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
