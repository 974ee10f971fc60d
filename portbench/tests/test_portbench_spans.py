"""The port's spans in a traced run: ``spans.reduce`` on hand-built event
lists, the readers of the port's span counts, and ``spans.py`` on a tiny
cell on the CPU."""

import contextlib
import io
import json
from types import SimpleNamespace

import pytest

import _tiny
from portbench import bench, spans, trace

HOST, DEV = 1, 7
BENCH_SPANS = ("lm.linearize", "lm.solve")


def _bench_events():
    """A window with a benchmark span, three launches and their kernels,
    a scalar read and the benchmark span's own device record."""
    return [("window", False, 0, 1000, 1, 0, HOST),
            ("lm.solve", False, 100, 900, 2, 0, HOST),
            ("cudaLaunchKernel", False, 130, 135, 11, 0, HOST),
            ("aten::_local_scalar_dense", False, 420, 430, 30, 0, HOST),
            ("cudaLaunchKernel", False, 460, 465, 12, 0, HOST),
            ("aten::_local_scalar_dense", False, 905, 930, 31, 0, HOST),
            ("cudaLaunchKernel", False, 910, 912, 13, 0, HOST),
            ("k1", True, 200, 300, 11, 0, DEV),
            ("k2", True, 500, 700, 12, 0, DEV),
            ("k3", True, 915, 960, 13, 0, DEV),
            ("lm.solve", True, 190, 710, 40, 0, DEV)]


def _program_events():
    """The port's spans around those: a trial, an explicit solve with its
    pair and factor stages, a chi2 read."""
    return [("g2o.lm.trial", False, 50, 950, 50, 0, HOST),
            ("g2o.schur.solve", False, 110, 890, 51, 0, HOST),
            ("g2o.schur.pairs", False, 120, 380, 52, 0, HOST),
            ("g2o.schur.factor", False, 450, 800, 53, 0, HOST),
            ("g2o.read.chi2", False, 900, 940, 54, 0, HOST)]


def test_program_spans_leave_the_summary_as_it_was():
    plain = trace.summarize(_bench_events(), BENCH_SPANS)
    spanned = trace.summarize(_bench_events() + _program_events(),
                              BENCH_SPANS)
    for field in plain._fields:
        if field != "idle_gaps":
            assert getattr(spanned, field) == getattr(plain, field), field
    # the gaps are the same; a program span may name one where no host
    # operation was open
    assert sum(v for _, v in spanned.idle_gaps) == pytest.approx(
        sum(v for _, v in plain.idle_gaps))
    assert dict(plain.idle_gaps) == pytest.approx(
        {"lm.solve": 615e-9, "host": 40e-9})


def test_reduce_without_program_spans_names_gaps_as_summarize():
    stats, gaps, stray = spans.reduce(_bench_events(), BENCH_SPANS)
    assert stats == {}
    assert dict(gaps) == pytest.approx(dict(trace.summarize(
        _bench_events(), BENCH_SPANS).idle_gaps))
    assert stray == {"lm.solve": 1, "window": 1}


def test_reduce_attributes_inclusively():
    events = _bench_events() + _program_events() + [
        # a device record of a program span is not work
        ("g2o.schur.pairs", True, 200, 300, 60, 0, DEV)]
    stats, gaps, stray = spans.reduce(events, BENCH_SPANS)
    ns = 1e-9
    expect = {  # calls, host, device, ops, idle
        "g2o.lm.trial": (1, 900, 345, 3, 615),
        "g2o.schur.solve": (1, 780, 300, 2, 415),
        "g2o.schur.pairs": (1, 260, 100, 1, 0),
        "g2o.schur.factor": (1, 350, 200, 1, 0),
        "g2o.read.chi2": (1, 40, 45, 1, 0),
    }
    assert set(stats) == set(expect)
    for name, (calls, host, dev, ops, idle) in expect.items():
        s = stats[name]
        assert s.calls == calls and s.ops == ops, name
        assert s.host_s == pytest.approx(host * ns), name
        assert s.device_s == pytest.approx(dev * ns), name
        assert s.idle_s == pytest.approx(idle * ns), name
    assert stats["g2o.lm.trial"].top_ops[0][0] == "k2"
    assert dict(gaps) == pytest.approx({
        "lm.solve/g2o.lm.trial": 200 * ns,
        "lm.solve/g2o.schur.solve": 415 * ns,
        "host": 40 * ns})
    # the read inside the pair stage lies in no read span
    assert stray == {"lm.solve/g2o.schur.solve": 1}
    d = spans.derived(stats)
    assert d["host_reads_per_trial"] == 1.0
    assert d["launches_per_trial"] == 3.0
    assert d["explicit_pairs_ms"] == pytest.approx(1e-4)
    assert d["explicit_factor_ms"] == pytest.approx(2e-4)
    assert d["cg_iter_ms"] is None and d["cg_idle_ms"] is None


def test_open_at_nested_and_sequential():
    items = [(0, 100, "a"), (10, 40, "b"), (20, 30, "c"), (50, 90, "b"),
             (95, 99, "d")]
    got = spans._open_at(items, [5, 25, 35, 45, 60, 97, 100, 150, 25])
    assert got == [("a",), ("a", "b", "c"), ("a", "b"), ("a",), ("a", "b"),
                   ("a", "d"), ("a",), (), ("a", "b", "c")]


def test_derived_implicit():
    S = spans.SpanStats
    stats = {"g2o.lm.trial": S(4, 0.4, 0.3, 2000, 0.05, []),
             "g2o.cg.iter": S(52, 0.156, 0.2, 1500, 0.03, []),
             "g2o.schur_implicit.solve": S(4, 0.2, 0.25, 1800, 0.04, []),
             "g2o.schur_implicit.cg": S(4, 0.16, 0.2, 1500, 0.028, []),
             "g2o.read.cg_stop": S(56, 0.01, 0.0, 112, 0.0, []),
             "g2o.read.chi2": S(8, 0.001, 0.0, 0, 0.0, [])}
    d = spans.derived(stats)
    assert d["host_reads_per_trial"] == 16.0
    assert d["launches_per_trial"] == 500.0
    assert d["cg_iter_ms"] == pytest.approx(3.0)
    assert d["cg_idle_ms"] == pytest.approx(7.0)
    assert d["explicit_pairs_ms"] is None
    assert spans.derived({}) == dict.fromkeys(d)


def _jobs(trials, cg):
    return [{"iterations": len(trials), "trials_per_iteration": trials,
             "cg_per_iteration": cg}]


def test_readers_of_the_ports_counts(monkeypatch):
    from g2o_tpu_torch.utils import tictoc

    host_reads = bench.reader(_tiny.ROOT, "host_reads_per_trial")
    cg_iter_ms = bench.reader(_tiny.ROOT, "cg_iter_ms")
    ctx = SimpleNamespace(jobs=_jobs([1, 2], [5, 8]))
    monkeypatch.setattr(tictoc, "_STATS", {})
    assert host_reads(ctx) is None and cg_iter_ms(ctx) is None
    for name, n, total in (("lm.trial", 3, 0.3), ("read.chi2", 6, 0.01),
                           ("read.gain", 3, 0.01), ("read.lambda0", 1, 0.0),
                           ("read.cg_stop", 16, 0.01), ("cg.iter", 13, 0.039),
                           ("linearize", 4, 0.1)):
        st = tictoc._STATS.setdefault(name, tictoc._Stat())
        for _ in range(n):
            st.add(total / n)
    assert host_reads(ctx) == pytest.approx(26 / 3)
    assert cg_iter_ms(ctx) == pytest.approx(3.0)
    # counts that are not the window's: nothing
    ctx = SimpleNamespace(jobs=_jobs([1, 1], [5, 8]))
    assert host_reads(ctx) is None and cg_iter_ms(ctx) is not None
    ctx = SimpleNamespace(jobs=_jobs([1, 2], [5, 7]))
    assert host_reads(ctx) is not None and cg_iter_ms(ctx) is None


@pytest.mark.parametrize("workload", ["venice1778.cold", "dubrovnik356.cold"])
def test_spans_tool_on_a_tiny_cell(tmp_path, monkeypatch, workload):
    from g2o_tpu_torch.utils import tictoc

    monkeypatch.delenv("G2O_ENABLE_TICTOC", raising=False)
    monkeypatch.setattr(tictoc, "_STATS", {})
    monkeypatch.setattr(spans, "ROOT", _tiny.make_root(tmp_path))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert spans.main(["--workload", workload, "--seed", str(_tiny.SEED),
                           "--seconds", "0", "--device", "cpu"]) == 0
    line = json.loads(buf.getvalue())
    res = line["result"]
    assert res["correct"] and line["jobs"] == res["attempted"]
    trials = line["spans"]["g2o.lm.trial"]["calls"]
    reads = sum(s["calls"] for k, s in line["spans"].items()
                if k.startswith("g2o.read."))
    assert reads == line["reads_expected"]
    # the harness's reader of the port's counts gives the same number
    assert res["metrics"]["host_reads_per_trial"]["value"] == \
        pytest.approx(reads / trials)
    assert line["derived"]["host_reads_per_trial"] == \
        pytest.approx(reads / trials)
    implicit = workload.startswith("venice")
    assert ("cg_iter_ms" in res["metrics"]) == implicit
    assert (line["derived"]["cg_iter_ms"] is not None) == implicit
    assert (line["derived"]["explicit_pairs_ms"] is not None) != implicit
    # the benchmark's own draw reads the host; the port's reads are spanned
    # (on the CPU, torch's Cholesky checks read inside the solver too)
    assert line["stray_reads"].get("job.draw", 0) == res["attempted"]
