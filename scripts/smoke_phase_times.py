#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with the wall seconds of each of its functions.

    python3 scripts/smoke_phase_times.py

Wraps every top-level function of ``chip_smoke`` in a timer, runs its
``main()`` unchanged (its output as ever on stdout), and prints on stderr
one line ``TIMES name=seconds/calls ...``, largest first.  The seconds are
inclusive: a phase's time holds the time of the functions it calls, so
the line says where a run's wall time goes (``trace`` = the profiled
iterations of every ``[trace_*]`` line) when a phase's depth is cut.
"""

import collections
import functools
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# helpers too small or too frequent to be worth a timer
SKIP = {"main", "phase", "bound", "_shape", "_spd", "_launches", "_counts",
        "_first_at_or_below", "_top", "_unit", "_reset"}


def main():
    total, calls = collections.Counter(), collections.Counter()

    def timed(fn, name):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                total[name] += time.perf_counter() - t0
                calls[name] += 1
        return run

    for name, fn in list(vars(chip_smoke).items()):
        if isinstance(fn, types.FunctionType) and name not in SKIP and \
                fn.__module__ == "chip_smoke":
            setattr(chip_smoke, name, timed(fn, name))
    try:
        chip_smoke.main()
    finally:
        print("TIMES " + " ".join(f"{k}={v:.1f}/{calls[k]}"
                                  for k, v in total.most_common()),
              file=sys.stderr)


if __name__ == "__main__":
    main()
