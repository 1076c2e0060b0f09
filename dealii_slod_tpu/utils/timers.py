"""Stage wall-clock timers — the replacement for the reference's
``dealii::TimerOutput`` sections ("1: Create Patches", "2: compute basis
function", ..., source/LOD.cc:16-19 and enter_subsection calls).  Sections
synchronize the device (``block_until_ready``) so the numbers are honest,
and the time JAX spends tracing, lowering and compiling inside a section is
reported in its own column instead of inside the stage's wall time."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

# process-wide seconds JAX has spent in tracing, lowering and compilation,
# fed by its monitoring events
_compile_s = [0.0]
_listening = [False]


def _on_duration(name: str, secs: float, **_) -> None:
    if name.startswith("/jax/core/compile/"):
        _compile_s[0] += secs


def compile_seconds() -> float:
    if not _listening[0]:
        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        _listening[0] = True
    return _compile_s[0]


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)      # wall time without compiles
        self.compile = defaultdict(float)
        self.counts = defaultdict(int)
        compile_seconds()

    @contextlib.contextmanager
    def section(self, name: str, sync: object = None):
        t0, c0 = time.perf_counter(), compile_seconds()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dc = compile_seconds() - c0
            self.totals[name] += max(time.perf_counter() - t0 - dc, 0.0)
            self.compile[name] += dc
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return ""
        width = max(len(k) for k in self.totals)
        lines = ["+----------------------------------------------------------+",
                 "| wall-clock timing summary (compile time apart)           |",
                 "+----------------------------------------------------------+"]
        for k in sorted(self.totals):
            lines.append(f"| {k:<{width}} | {self.counts[k]:4d} | "
                         f"{self.totals[k]:10.4f}s | compile "
                         f"{self.compile[k]:9.4f}s |")
        lines.append(f"| {'TOTAL':<{width}} |      | "
                     f"{sum(self.totals.values()):10.4f}s | compile "
                     f"{sum(self.compile.values()):9.4f}s |")
        lines.append("+----------------------------------------------------------+")
        return "\n".join(lines)
