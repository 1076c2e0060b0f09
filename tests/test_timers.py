"""StageTimer keeps JAX compile time out of a stage's wall time."""

import time

import jax
import jax.numpy as jnp

from dealii_slod_tpu.utils.timers import StageTimer


def test_compile_time_reported_apart():
    t = StageTimer()
    f = jax.jit(lambda x: jnp.cumsum(jnp.sin(x) @ x.T, axis=0))
    x = jnp.ones((64, 64))
    with t.section("first"):
        f(x).block_until_ready()
    with t.section("second"):
        f(x).block_until_ready()
    assert t.compile["first"] > 0.0
    assert t.compile["second"] == 0.0
    assert t.totals["first"] >= 0.0
    assert "compile" in t.summary()


def test_plain_wall_time_kept():
    t = StageTimer()
    with t.section("sleep"):
        time.sleep(0.05)
    assert t.totals["sleep"] >= 0.04 and t.compile["sleep"] == 0.0
