"""Host spans inside the program: named stretches of host time on one clock.

The companion of `repro_torch.metrics.events.EventLog`: the log stamps a
request's lifecycle, the spans say where a step's host time went. Both
read ``time.perf_counter_ns()``, so a request's events and the spans of
the steps that served it lie on the same clock.

Two levels, set with `set_level`:

* ``CLOCK``  — the engine's stages (``engine.*``), about ten spans a step,
  the capture of the decode megastep's CUDA graph
  (``model.graph_capture``, rare) and each Mamba-2 mixer of a prefill
  chunk (``model.ssm_prefill``), opened with `span`;
* ``DETAIL`` — also the model's, the MoE layer's and the kernel
  bindings' (``model.*``, ``moe.*``, ``kernel.*``), opened with `detail`:
  hundreds a decode megastep, meant for the few steps a profiler records.

Off (the default) `span` and `detail` make one comparison and return one
shared object whose ``with`` does nothing: no clock read, no allocation,
no ``torch`` call. On, each span opens ``torch.profiler.record_function``
under its name too, so that a profiler puts the range on its timeline
beside the device's activity, and adds its duration to per-name totals:
count, total nanoseconds and self nanoseconds (the total less what the
spans opened inside it cover). `take` returns the totals and resets them.
Nothing is written out. Spans nest on one stack: open them from one
thread.

The profiler stamps its events on the system's real-time clock (Unix
nanoseconds), not on ``perf_counter_ns``; `clock_offset_ns` is the
difference to add to a span's stamp to place it on the profiler's.
"""

from __future__ import annotations

import time

import torch

OFF, CLOCK, DETAIL = 0, 1, 2

#: the engine's spans and the megastep graph's capture (`span`, level
#: ``CLOCK``)
ENGINE = ("engine.step", "engine.admit", "engine.schedule", "engine.pages",
          "engine.stage", "engine.prefill", "engine.decode", "engine.fetch",
          "engine.tokens", "model.graph_capture", "model.ssm_prefill")
#: the model's, the MoE layer's and each kernel binding's (`detail`, level
#: ``DETAIL``); one ``kernel.<binding>`` per key of ``kernels.build.launches``
DETAILED = ("model.decode_step", "model.embed", "model.attention",
            "model.ssm", "model.mlp", "model.head", "model.sample",
            "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
            "moe.shared",
            "kernel.paged_decode_attention",
            "kernel.paged_decode_attention_multi", "kernel.decode_attention",
            "kernel.decode_attention_int8", "kernel.probe_update",
            "kernel.flash_attention", "kernel.ssd_scan",
            "kernel.ssm_state_update", "kernel.moe_experts")
#: every span name the program opens
NAMES = ENGINE + DETAILED

_level = OFF
_stack: list = []
_totals: dict[str, list] = {}     # name -> [count, total ns, self ns, first]


class _Off:
    """The shared span of a switched-off level."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.inner = 0
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        _stack.pop()
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0, self.t0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.inner
        if _stack:
            _stack[-1].inner += dur
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A span of the engine's level (``CLOCK``), as a context manager."""
    if _level < CLOCK:
        return _OFF
    return _Span(name)


def detail(name: str):
    """A span of the model's level (``DETAIL``), as a context manager."""
    if _level < DETAIL:
        return _OFF
    return _Span(name)


def set_level(level: int) -> None:
    """Switch to ``OFF``, ``CLOCK`` or ``DETAIL``; the totals stay."""
    global _level
    if level not in (OFF, CLOCK, DETAIL):
        raise ValueError(f"unknown span level {level!r}")
    _level = level


def take() -> dict[str, dict]:
    """The totals since the last call, by name: ``count``, ``total_ns``,
    ``self_ns`` and ``first_ns`` (the ``perf_counter_ns`` stamp at which
    the first of them opened); then they start again from nothing."""
    out = {name: {"count": c, "total_ns": t, "self_ns": s, "first_ns": f}
           for name, (c, t, s, f) in _totals.items()}
    _totals.clear()
    return out


def clock_offset_ns() -> int:
    """Nanoseconds from ``perf_counter_ns`` to the real-time clock on
    which ``torch.profiler`` stamps its events, read now."""
    return time.time_ns() - time.perf_counter_ns()
