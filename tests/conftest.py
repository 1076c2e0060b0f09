"""Test configuration: the CPU backend with 8 virtual devices (for the
sharding tests) and float64 enabled (the 1e-10 parity target vs the deal.II
reference requires double precision, SURVEY.md §7).

The suite runs on the CPU only (``JAX_PLATFORMS=cpu``).  What needs the
GPU — compiled kernels at full width, timings — is checked on the card by
``python chip_smoke.py``, whose phase functions these tests cover at tiny
sizes."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from dealii_slod_tpu.utils.runtime import enable_compile_cache  # noqa: E402

# the suite is compile-dominated on CPU (one fat SLOD kernel per distinct
# config); repeat runs skip all of it
enable_compile_cache(os.path.join(os.path.dirname(__file__), os.pardir),
                     ".jax_cache_cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
