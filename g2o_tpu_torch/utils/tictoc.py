"""Port of ``g2o_tpu/utils/tictoc.py`` (plain Python, as there).

String-keyed accumulating timers — analogue of the reference ``tictoc``
(``g2o/stuff/tictoc.h:40-75``): enabled by the ``G2O_ENABLE_TICTOC`` env
var, tracks call count / total / min / max / mean per key."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager


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
    s.count += 1
    s.total += dt
    s.min = min(s.min, dt)
    s.max = max(s.max, dt)
    return dt


@contextmanager
def tictoc(key: str):
    tic(key)
    try:
        yield
    finally:
        toc(key)


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
