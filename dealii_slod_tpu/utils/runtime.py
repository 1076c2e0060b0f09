"""Process set-up for runs on the card: where JAX keeps its persistent
compilation cache, and which card the process runs on."""

from __future__ import annotations

import os
import subprocess

import jax


def enable_compile_cache(root: str, name: str) -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is set here); otherwise keep the cache at the fixed
    path ``<root>/<name>``.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(root), name)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power() -> str:
    """``name, power.limit`` of the card(s) as ``nvidia-smi`` reports them
    (a child process that does not open the card through JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
