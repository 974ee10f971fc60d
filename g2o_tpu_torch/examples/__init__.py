"""The examples of ``examples/`` on the port, one module each, run as
``python -m g2o_tpu_torch.examples.<name> [arguments] [-device cpu]``.

Each takes the JAX script's arguments and sizes and prints its lines.
``-device`` (anywhere on the command line) names the device its problems
are built on: the CUDA card unless it says ``cpu``; without a card the
run stops with an error rather than moving to the CPU.  ``main(argv)``
reads ``sys.argv[1:]`` when ``argv`` is None and returns what the JAX
script's ``main()`` returns.  :func:`output_difference` compares what two
runs of an example printed (the card against the CPU, or the port
against the JAX script)."""

import re
import sys


def split_device(argv=None):
    """``(device, arguments)`` of a command line: ``-device X`` taken out
    of ``argv`` (``sys.argv[1:]`` when None), ``"cuda"`` when absent."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "-device" in args:
        i = args.index("-device")
        if i + 1 >= len(args) or args[i + 1] not in ("cuda", "cpu"):
            raise SystemExit("-device takes cuda or cpu")
        device = args[i + 1]
        del args[i:i + 2]
    return device, args


# a printed number; the LM loop's verbose line; a run's wall time "(1.23s)"
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
_LM_LINE = re.compile(r"iteration= (\d+)\s+chi2= (\S+)")
_WALL = re.compile(r"\(\d+\.\d+s\)")


def _close(x, y, rtol):
    """``x`` within ``rtol`` of ``y`` or one unit of ``y``'s last printed
    digit."""
    frac = y.lower().split("e")[0]
    ulp = 10.0 ** -(len(frac.split(".")[1]) if "." in frac else 0)
    if "e" in y.lower():
        ulp *= 10.0 ** int(y.lower().split("e")[1])
    return abs(float(x) - float(y)) <= max(rtol * abs(float(y)), ulp)


def _split(text):
    """The LM loop's ``(iteration, chi2)`` pairs, and every other line as
    (its text with the numbers and wall times taken out, its numbers)."""
    iters, rest = [], []
    for ln in text.splitlines():
        m = _LM_LINE.match(ln)
        if m:
            iters.append(m.groups())
            continue
        ln = _WALL.sub("", ln)
        rest.append((_NUM.sub("#", ln), _NUM.findall(ln)))
    return iters, rest


def output_difference(got, want, rtol=1e-6, floor=1e-9):
    """``None`` when two runs printed the same, else the first difference:
    the same lines with the wall times taken out, every printed number
    within ``rtol`` of the other or one unit of its last printed digit.
    The LM loop's verbose ``iteration=`` lines are held by their chi2
    alone: once chi2 is at its floor, LM's λ and its trial counts follow
    gains at the rounding level and the runs may stop an iteration apart,
    so the longer run's extra lines must sit at the shorter run's last
    chi2 (within ``floor``)."""
    (ia, ra), (ib, rb) = _split(got), _split(want)
    for (ka, ca), (kb, cb) in zip(ia, ib):
        if ka != kb or not _close(ca, cb, rtol):
            return f"iteration {ka}: chi2 {ca} against {cb}"
    short, long_ = sorted((ia, ib), key=len)
    for k, c in long_[len(short):]:
        last = float(short[-1][1]) if short else float("nan")
        if not abs(float(c) - last) <= floor * abs(last):
            return f"iteration {k}: chi2 {c} past the other run's {last}"
    if [t for t, _ in ra] != [t for t, _ in rb]:
        return "the lines differ"
    for (t, na), (_, nb) in zip(ra, rb):
        for x, y in zip(na, nb):
            if not _close(x, y, rtol):
                return f"{t!r}: {x} against {y}"
    return None
