"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's: the dataflow passes and ``Netlist.stats()`` / ``LevelPlan.
stats()`` on every generator of ``generator_registry``, the structural
verifier on adversarial netlists, the secret-flow lint on the reference
tests' seeded leaks, the protocol-RNG lint (torch's default generator
included), the CLI's exit codes, and the port's own baseline on its clean
tree. Every comparison is exact: the counters and findings are the same
numpy and AST code in both packages."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.analysis import cli as j_cli
from repro.analysis import netcheck as JNC
from repro.analysis import secretflow as JSF
from repro.analysis.jit_hygiene import run_jit_hygiene as j_rng_lint
from repro.core.netlist import Netlist as JNetlist
from repro.core.netlist import compile_level_plan as j_compile
from repro_torch.analysis import Baseline, NetlistError
from repro_torch.analysis import cli as t_cli
from repro_torch.analysis import netcheck as TNC
from repro_torch.analysis import secretflow as TSF
from repro_torch.analysis.jit_hygiene import run_jit_hygiene
from repro_torch.core.netlist import Netlist as TNetlist
from repro_torch.core.netlist import OP_AND, OP_INV, OP_XOR
from repro_torch.core.netlist import compile_level_plan as t_compile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BASELINE = "src/repro_torch/analysis/baseline.json"
GENERATORS = sorted(TNC.generator_registry())


def _nets(gates, num_wires, g_in=(), e_in=(), outputs=(), const_bits=None):
    """The same raw netlist in both packages, bypassing the builders."""
    kw = dict(
        num_wires=num_wires,
        op=np.asarray([g[0] for g in gates], np.uint8),
        in0=np.asarray([g[1] for g in gates], np.int32),
        in1=np.asarray([g[2] for g in gates], np.int32),
        out=np.asarray([g[3] for g in gates], np.int32),
        garbler_inputs=np.asarray(list(g_in), np.int32),
        evaluator_inputs=np.asarray(list(e_in), np.int32),
        outputs=np.asarray(list(outputs), np.int32),
        const_bits=dict(const_bits or {}), name="t")
    return JNetlist(**kw), TNetlist(**kw)


@pytest.mark.parametrize("name", GENERATORS)
def test_dataflow_and_stats_equal_reference(name):
    assert sorted(JNC.generator_registry()) == GENERATORS
    jn = JNC.generator_registry()[name]()
    tn = TNC.generator_registry()[name]()
    assert TNC.dataflow_summary(tn) == JNC.dataflow_summary(jn)
    st = tn.stats()
    assert st == jn.stats()
    for key in ("removable_and", "dead_gates", "dup_and", "dead_wires"):
        assert key in st
    jr = JNC.analyze_netlist(jn, histograms=True)
    tr = TNC.analyze_netlist(tn, histograms=True)
    for f in ("gates", "and_gates", "dead_gates", "dead_and",
              "foldable_gates", "foldable_and", "dup_gates", "dup_and",
              "removable_and", "dead_wires"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert np.array_equal(tr.and_per_level, jr.and_per_level)
    assert np.array_equal(tr.live_per_level, jr.live_per_level)
    assert TNC.verify_netlist(tn) == JNC.verify_netlist(jn) == []


@pytest.mark.parametrize("name", ["add16", "gelu", "layernorm_reduced4"])
def test_level_plan_stats_carry_dataflow_counters(name):
    jp = j_compile(JNC.generator_registry()[name]())
    tp = t_compile(TNC.generator_registry()[name]())
    assert tp.stats() == jp.stats()
    assert tp.stats()["removable_and"] == 0


@pytest.mark.parametrize("case", [
    # (gates, wires, g_in, e_in, outputs, const_bits)
    ([(OP_AND, 0, 3, 2), (OP_AND, 2, 1, 3)], 4, [0], [1], [3], None),
    ([(OP_XOR, 0, 5, 2)], 6, [0], [1], [2], None),
    ([(OP_XOR, 0, 1, 2)], 3, [0], [1], [2], {2: 1, 0: 0}),
    ([(OP_XOR, 0, 1, 3), (OP_AND, 2, 2, 4)], 5, [0], [1], [3, 4], {2: 1}),
    ([(OP_XOR, 0, 1, 2), (OP_AND, 0, 1, 2)], 4, [0], [1], [2, 3], None),
    ([(7, 0, 1, 2)], 3, [0], [1], [2], None),
    ([(OP_INV, 0, 1, 2)], 3, [0], [1], [2], None),
    # dataflow: const fold, duplicate, INV cancellation, dead cone
    ([(OP_AND, 0, 2, 3), (OP_XOR, 1, 3, 4)], 5, [0], [1], [4], {2: 0}),
    ([(OP_AND, 0, 1, 2), (OP_AND, 1, 0, 3), (OP_XOR, 2, 3, 4)], 5, [0],
     [1], [4], None),
    ([(OP_INV, 0, 0, 2), (OP_AND, 0, 2, 3), (OP_XOR, 1, 3, 4)], 5, [0],
     [1], [4], None),
    ([(OP_XOR, 0, 1, 2), (OP_AND, 0, 1, 3)], 4, [0], [1], [2], None),
], ids=["cycle", "dangling", "const-conflict", "unreachable", "dup-driver",
        "opcode", "inv-arity", "fold", "cse", "inv-cancel", "dead"])
def test_verifier_and_dataflow_on_adversarial_netlists(case):
    jn, tn = _nets(*case)
    errs = TNC.verify_netlist(tn)
    assert errs == JNC.verify_netlist(jn)
    if errs:
        with pytest.raises(NetlistError):
            TNC.verify_netlist_strict(tn)
    else:
        assert TNC.analyze_netlist(tn).summary() == \
            JNC.analyze_netlist(jn).summary()


def test_netcheck_pass_clean_on_the_port_s_generators():
    assert TNC.run_netcheck() == [] == JNC.run_netcheck()


# ---------------------------------------------------------------------------
# secret-flow lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["leaky_party", "leaky_seeds",
                                     "leaky_spans", "leaky_retry"])
def test_secretflow_catches_the_reference_tests_seeded_leaks(fixture):
    path = os.path.join(FIXTURES, fixture + ".py")
    rel = f"tests/fixtures/{fixture}.py"
    got = [f.to_dict() for f in TSF.lint_file(path, rel=rel)]
    assert got == [f.to_dict() for f in JSF.lint_file(path, rel=rel)]
    assert got and all(f["line"] > 0 for f in got)
    flagged = {f["symbol"].rsplit(".", 1)[-1] for f in got}
    assert all(s.startswith("leak_") for s in flagged), flagged


def test_secretflow_quiet_on_the_port_s_shipped_paths():
    for rel in ("src/repro_torch/net/faults.py",
                "src/repro_torch/net/resilience.py",
                "src/repro_torch/serve/gateway.py",
                "src/repro_torch/net/party.py"):
        assert rel in TSF.DEFAULT_PATHS
    assert all(os.path.exists(os.path.join(REPO, p))
               for p in TSF.DEFAULT_PATHS)
    assert TSF.run_secretflow(REPO) == []


# ---------------------------------------------------------------------------
# protocol-RNG lint
# ---------------------------------------------------------------------------

_TORCH_RNG = '''\
import torch


def leaky(x, n):
    a = torch.rand(3)
    b = torch.randint(0, 5, (n,))
    c = torch.randperm(n)
    return a, b, c, torch.randn_like(x)


def seeded(x, n, gen):
    g = torch.Generator().manual_seed(1)
    return (torch.randint(0, 5, (n,), generator=gen),
            torch.rand(3, generator=g), torch.ones(n))
'''


def test_rng_lint_catches_global_draws(tmp_path):
    bad = os.path.join(FIXTURES, "bad_jit.py")
    got = [f.to_dict() for f in run_jit_hygiene(REPO, proto_paths=[bad])]
    want = [f.to_dict() for f in j_rng_lint(REPO, jit_paths=[bad],
                                            proto_paths=[bad])
            if f.rule == "proto-global-rng"]
    assert got == want and [f["symbol"] for f in got] == ["np.random.rand"]
    p = tmp_path / "torch_rng.py"
    p.write_text(_TORCH_RNG)
    got = run_jit_hygiene(str(tmp_path), proto_paths=[str(p)])
    assert [(f.rule, f.symbol, f.line) for f in got] == [
        ("proto-global-rng", "torch.rand", 5),
        ("proto-global-rng", "torch.randint", 6),
        ("proto-global-rng", "torch.randperm", 7),
        ("proto-global-rng", "torch.randn_like", 8)]


def test_rng_lint_quiet_on_the_port_s_protocol_paths():
    assert run_jit_hygiene(REPO) == []


# ---------------------------------------------------------------------------
# CLI and baseline
# ---------------------------------------------------------------------------


def _rc(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:  # argparse usage errors
        rc = e.code
    out = capsys.readouterr().out
    return rc, out


def test_cli_exit_codes_match_reference(tmp_path, capsys):
    leaky = os.path.join(FIXTURES, "leaky_party.py")
    cases = [
        ["--netlists"],
        ["--secretflow", leaky],
        ["--secretflow", "--json", leaky],
        ["--jit", os.path.join(FIXTURES, "bad_jit.py")],
        [],  # no pass selected: usage error
        ["--secretflow", "--update-baseline", leaky],  # needs --baseline
        ["--secretflow", "--baseline", str(tmp_path / "absent.json"),
         leaky],
    ]
    for argv in cases:
        t = _rc(t_cli.main, argv + ["--root", REPO], capsys)
        j = _rc(j_cli.main, argv + ["--root", REPO], capsys)
        assert t[0] == j[0], argv
        if "--json" in argv:
            td, jd = json.loads(t[1]), json.loads(j[1])
            assert td["new"] == jd["new"] > 0
            assert td["findings"] == jd["findings"]
    # a baseline accepting the findings flips the exit back to 0
    for main, name in ((t_cli.main, "t.json"), (j_cli.main, "j.json")):
        bp = str(tmp_path / name)
        assert _rc(main, ["--secretflow", "--root", REPO, "--baseline", bp,
                          "--update-baseline", leaky], capsys)[0] == 0
        assert _rc(main, ["--secretflow", "--root", REPO, "--baseline", bp,
                          leaky], capsys)[0] == 0


def test_cli_module_entrypoint():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--netlists",
         "--root", REPO],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean: no findings" in proc.stdout


def test_port_baseline_matches_clean_tree(capsys):
    base = Baseline.load(os.path.join(REPO, BASELINE))
    assert base.entries == {}  # nothing grandfathered in the port
    assert t_cli.main(["--all", "--root", REPO, "--baseline", BASELINE]) == 0
    assert "clean: no findings" in capsys.readouterr().out
