"""CPU rehearsal of the harness at a tiny width, in a fresh process: the
tiny cell's configuration, mix and metric are found by name though they
exist only as new files; a ``--trace 0`` and a ``--trace 1`` run each
print one last line with the contract's keys; and nothing is written
outside the checkout, HOME, XDG_CACHE_HOME and TMPDIR."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pitbench_tiny as tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}

DRIVER = textwrap.dedent('''
    import contextlib, io, json, os, sys
    writes = []

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            if isinstance(path, int):
                return
            bits = os.O_WRONLY | os.O_RDWR | os.O_CREAT
            if (mode and any(c in mode for c in "wax+")) or (
                    isinstance(flags, int) and flags & bits):
                writes.append(str(path))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                       "os.unlink", "os.symlink", "shutil.copyfile",
                       "shutil.rmtree"):
            writes.append(str(args[0]))

    sys.addaudithook(hook)
    sys.path[:0] = ["src", "."]
    from pitbench import harness
    lines = []
    for trace in (0, 1):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = harness.main(["--workload", sys.argv[1], "--seed",
                               str(2**31 + 11), "--seconds", "0.01",
                               "--trace", str(trace)], device="cpu")
        lines.append([rc, buf.getvalue()])
    print(json.dumps({"runs": lines, "writes": writes}))
''')


def test_tiny_cell_runs_found_by_name_and_writes_nowhere_else(tmp_path):
    ck = tiny.make_checkout(tmp_path / "ck")
    env = dict(os.environ)
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[var] = str(tmp_path / var.lower())
        os.makedirs(env[var])
    env["OMP_NUM_THREADS"] = "1"
    got = subprocess.run([sys.executable, "-c", DRIVER, tiny.CELL],
                         cwd=ck, env=env, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    lines = []
    for rc, text in out["runs"]:
        assert rc == 0
        line = json.loads(text.strip().splitlines()[-1])
        assert KEYS <= set(line), line
        assert list(line)[-1] == "checks"
        assert line["correct"] is True, line["checks"]
        assert line["attempted"] >= 1 and line["failed"] == 0
        lines.append(line)
    e2e, layer = lines
    assert set(e2e["metrics"]) == {"online_s", "offline_s", "setup_s"}
    assert tiny.METRIC in layer["metrics"]
    # q, k, v, softmax, o, wo, ln1, act, w2, ln2
    assert layer["metrics"][tiny.METRIC]["value"] == 10
    assert {"circuit.and_M", "exec.plan_s", "wire_MB"} <= set(
        layer["metrics"])
    assert len(e2e["requests"][0]) == 3
    assert {"busy_s", "window_s"} <= set(layer["device"])
    allowed = [str(ck), "/dev/null"] + [
        str(tmp_path / d) for d in ("home", "xdg_cache_home", "tmpdir")]
    stray = [w for w in out["writes"]
             if not any(os.path.abspath(os.path.join(ck, w)).startswith(a)
                        for a in allowed)]
    assert not stray, stray


def test_per_layer_metrics_name_only_cells_that_report_what_they_move():
    from pitbench import harness

    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    reported = {c: {m["name"] for m in harness.load_spec(c)["end_to_end"]}
                for c in cells}
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2, c
        assert harness.load_spec(c)["per_layer"], c
    for m in bench["per_layer"]:
        for c in m.get("workloads", cells):
            assert m["moves"] in reported[c], (m["name"], c)
