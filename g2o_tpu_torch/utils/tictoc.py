"""Port of ``g2o_tpu/utils/tictoc.py`` (plain Python, as there).

String-keyed accumulating timers — analogue of the reference ``tictoc``
(``g2o/stuff/tictoc.h:40-75``): enabled by the ``G2O_ENABLE_TICTOC`` env
var, tracks call count / total / min / max / mean per key.

:func:`span` marks a stage of the program.  It is on while a
``torch.profiler`` records or ``G2O_ENABLE_TICTOC`` is set, and a shared
no-op otherwise.  While a profiler records, a span is a host range named
``"g2o." + name`` in the profiler's trace, on the clock of the kernels it
launches; while it is on, it also accumulates here under ``name``, so
``stats()`` holds a profiled run's span counts and host seconds."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


class _Stat:
    __slots__ = ("count", "total", "min", "max", "_start")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._start = None

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


_STATS: dict[str, _Stat] = {}


def enabled() -> bool:
    return bool(os.environ.get("G2O_ENABLE_TICTOC"))


def tic(key: str):
    if not enabled():
        return
    _STATS.setdefault(key, _Stat())._start = time.perf_counter()


def toc(key: str) -> float:
    if not enabled():
        return 0.0
    s = _STATS.get(key)
    if s is None or s._start is None:
        return 0.0
    dt = time.perf_counter() - s._start
    s._start = None
    s.add(dt)
    return dt


@contextmanager
def tictoc(key: str):
    tic(key)
    try:
        yield
    finally:
        toc(key)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        # a FUNCTION-scoped range: a host event of the trace that, unlike
        # ``record_function``'s user scope, puts no annotation on the
        # device's timeline, so kernel and idle intervals stay as they are
        self._range = (torch._C._profiler._RecordFunctionFast("g2o." + name)
                       if profiled else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        _STATS.setdefault(self.name, _Stat()).add(
            time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one stage of the program (see the module
    docstring); nothing but a check of the profiler's state and of
    ``G2O_ENABLE_TICTOC`` while neither is on."""
    profiled = torch.autograd._profiler_enabled()
    if not profiled and not enabled():
        return _NO_SPAN
    return _Span(name, profiled)


def stats() -> dict:
    return {k: dict(count=s.count, total=s.total, min=s.min, max=s.max,
                    mean=s.mean) for k, s in _STATS.items()}


def print_stats(stream=None):
    import sys

    stream = stream or sys.stderr
    for k in sorted(_STATS):
        s = _STATS[k]
        stream.write(
            f"{k}: count={s.count} total={s.total:.6f}s mean={s.mean:.6f}s "
            f"min={s.min:.6f}s max={s.max:.6f}s\n")


def reset():
    _STATS.clear()
