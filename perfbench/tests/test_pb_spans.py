"""The readers of the program's spans and request stamps, on hand-made
records, and on small traced runs on the CPU."""
from types import SimpleNamespace as NS

import pytest

from perfbench import bench, harness
from perfbench.tests import tiny
from perfbench.trace import Trace

CHAT = "command-r-plus-104b-l8.chat_1k_256"
RAG = "command-r-plus-104b-l8.rag_4k"


def read(name, r):
    return bench.metric_reader(name)(name, r)


def _ticks(n=3, period=100.0):
    """``n`` decode ticks, host and card, each: ``repro.serve.decode`` over
    [0, 60) of its period, ``repro.engine.wait`` over [60, 90); the card busy
    over [5, 30) and [40, 88), so idle over [30, 40) (midpoint in the decode
    range) and [88, 105) (midpoint 96.5, after the wait)."""
    host, ops = [], []
    for t in range(n):
        b = t * period
        host += [(b, b + 95, "pb.tick"), (b, b + 60, "repro.serve.decode"),
                 (b + 2, b + 20, "aten::mm"), (b + 60, b + 90, "repro.engine.wait")]
        ops += [(b + 5, b + 30, "gemm"), (b + 40, b + 88, "gemm")]
    tr = Trace(sorted(ops), {}, sorted(host, key=lambda h: (h[0], -h[1])), {})
    ctx = NS(traffic={"clients": 4, "trace": {"decode_ticks": n, "skip": 1}})
    return {"ctx": ctx, "trace": tr, "seg": {"ticks": [{"clen": 10 + t} for t in range(n)]}}


def test_launch_and_wait_are_the_means_of_their_ranges():
    r = _ticks()
    assert read("decode_launch_ms.gen", r) == pytest.approx(60 / 1e3)
    assert read("decode_wait_ms.gen", r) == pytest.approx(30 / 1e3)


def test_idle_launch_counts_the_gaps_whose_midpoints_lie_in_a_decode_range():
    r = _ticks()
    # three gaps of 10 us inside the decode ranges; the two of 17 us between
    # ticks (midpoints 96.5 and 196.5, after the wait) are not counted
    assert read("idle_launch_ms.gen", r) == pytest.approx(3 * 10 / 3 / 1e3)


@pytest.mark.parametrize("ops,want_us", [
    ([(0.0, 50.0, "k"), (64.0, 80.0, "k")], 14.0),    # midpoint 57: inside, counted whole
    ([(0.0, 55.0, "k"), (70.0, 80.0, "k")], 0.0),     # midpoint 62.5: past the range's end
])
def test_a_gap_straddling_a_range_end_counts_by_its_midpoint(ops, want_us):
    r = _ticks(n=1)
    r["trace"] = Trace(ops, {}, [(0.0, 60.0, "repro.serve.decode")], {})
    assert read("idle_launch_ms.gen", r) == pytest.approx(want_us / 1e3)


def test_the_decode_readers_read_nothing_without_the_spans_or_outside_a_decode_segment():
    r = _ticks()
    r["trace"].host[:] = [h for h in r["trace"].host if not h[2].startswith("repro.")]
    for name in ("decode_launch_ms.gen", "decode_wait_ms.gen", "idle_launch_ms.gen"):
        assert read(name, r) is None
    r = _ticks()
    r["ctx"].traffic["trace"] = {"waves": 1}
    for name in ("decode_launch_ms.gen", "decode_wait_ms.gen", "idle_launch_ms.gen"):
        assert read(name, r) is None
    r = _ticks()
    r["trace"].ops.clear()                    # no card: no idle to read
    assert read("idle_launch_ms.gen", r) is None


def _flight(submit, admit, first):
    req = NS(t_submit=submit, t_admit=admit)
    return NS(req=req, first=first)


def test_queue_wait_is_the_p95_over_the_window_requests_with_a_first_token():
    inside = [_flight(0.0, w, 5.0) for w in (0.0, 0.1, 0.2, 0.3, 0.4)]
    late = [_flight(0.0, 9.0, 11.0)]           # first token after the window's end
    pending = [_flight(0.0, 8.0, None)]        # no first token
    r = {"rec": {"flights": inside + late + pending, "end": 10.0}}
    assert read("queue_wait_ms.ttft", r) == pytest.approx(bench.percentile(
        [0.0, 100.0, 200.0, 300.0, 400.0], 95))


def test_queue_wait_reads_nothing_without_the_stamps():
    r = {"rec": {"flights": [NS(req=NS(), first=1.0)], "end": 10.0}}
    assert read("queue_wait_ms.ttft", r) is None


def test_the_new_metrics_name_no_profiler_attribution():
    for cell in (CHAT, RAG):
        assert harness.attributed_names(bench.per_layer_of(bench.benchmark(), cell)) == []


@pytest.mark.parametrize("cell,names", [
    (CHAT, ["decode_launch_ms.gen", "decode_wait_ms.gen"]),
    (RAG, ["queue_wait_ms.ttft"]),
])
def test_a_small_traced_run_reports_them(cell, names):
    out = harness.run(tiny.ctx(cell, seconds=0.5, trace=True))
    assert out["correct"]
    for name in names:
        assert out["metrics"][name]["value"] > 0, name
    # the CPU has no card: no idle gaps to set against the decode ranges
    assert "idle_launch_ms.gen" not in out["metrics"]
