"""The readers of the program's GC host-work spans, on a hand-made view:
synthetic spans, a device timeline whose busy intervals overlap them, two
requests, and spans outside the window or after set-up; and a tiny traced
run on the CPU that reports ``circuit.build_s``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

import pitbench_tiny as tiny  # puts src/ and the root on the path
from pitbench import harness
from pitbench.trace import DeviceTimeline, SpanRec

TID = 7
#: the idle-share readers and the one span each reads
IDLE = [("exec.label_draw_s", "garble.draw"),
        ("protocol.mask_s.offline", "gc_offline.masks"),
        ("protocol.encode_s.online", "gc_online.encode"),
        ("protocol.decode_s.online", "gc_online.decode")]


def view(spans, busy=(), window=(0, 100), requests=2, setup_end=0):
    tl = DeviceTimeline([("kernel", a, b) for a, b in busy])
    return harness.View(served=[types.SimpleNamespace()] * requests,
                        window=window, spans=spans, device=tl,
                        setup_end=setup_end)


def rec(name, t0, t1, path=None, tid=TID):
    return SpanRec(name, path or name, t0, t1, tid)


@pytest.mark.parametrize("metric,name", IDLE)
def test_one_span_less_the_device_busy_inside_it(metric, name):
    # 0-10 ns with the device busy 2-4 ns: 8 ns idle, over 2 requests
    v = view([rec(name, 0, 10)], busy=[(2, 4)])
    assert harness.reader(metric)(v) == pytest.approx(4e-9)


@pytest.mark.parametrize("metric,name", IDLE)
def test_two_requests_and_spans_outside_the_window(metric, name):
    spans = [rec(name, 0, 10, "pitbench.offline/x/" + name),
             rec(name, 20, 30),  # busy 25-40 covers 5 ns of it
             rec(name, 90, 110),  # ends after the window
             rec("pitbench.garble", 0, 50),  # another name
             rec(name, 40, 45, tid=TID + 1)]  # another thread, counted
    v = view(spans, busy=[(2, 4), (25, 40)])
    assert harness.reader(metric)(v) == pytest.approx((8 + 5 + 5) / 2 * 1e-9)


@pytest.mark.parametrize("metric,name", IDLE)
def test_idle_readers_need_the_span_and_the_device_trace(metric, name):
    read = harness.reader(metric)
    # a program without the span (the parent commit): no value, no error
    assert read(view([rec("gc_online", 0, 10)])) is None
    assert read(view(None)) is None
    # a CPU run: no device trace
    v = view([rec(name, 0, 10)])
    v.device = None
    assert read(v) is None


def test_circuit_build_s_counts_set_up_spans_only():
    read = harness.reader("circuit.build_s")
    spans = [rec("circuit.build", 0, 300), rec("circuit.build", 400, 1000),
             rec("gc_exec.get_executor", 0, 5000),
             rec("circuit.build", 6000, 6100)]  # after set-up
    assert read(view(spans, setup_end=5000)) == pytest.approx(900e-9)
    assert read(view(spans[2:], setup_end=5000)) is None
    assert read(view(None)) is None


RUN = '''
import contextlib, io, sys
sys.path[:0] = ["src", "."]
from pitbench import harness
with contextlib.redirect_stdout(io.StringIO()) as buf:
    rc = harness.main(["--workload", sys.argv[1], "--seed", str(2**31 + 5),
                       "--seconds", "0.01", "--trace", "1"], device="cpu")
print(rc)
print(buf.getvalue().strip().splitlines()[-1])
'''


def test_a_tiny_traced_run_reports_circuit_build_s(tmp_path):
    ck = tiny.make_checkout(tmp_path / "ck")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    got = subprocess.run([sys.executable, "-c", RUN, tiny.CELL], cwd=ck,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    rc, line = got.stdout.strip().splitlines()[-2:]
    assert rc == "0"
    metrics = json.loads(line)["metrics"]
    assert metrics["circuit.build_s"]["value"] > 0
    # the idle-share readers need a device trace, which a CPU run lacks
    assert not {m for m, _ in IDLE} & set(metrics)
