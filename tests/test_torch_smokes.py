"""The port's CI smokes (``scripts/*_torch.py``) on the CPU, each program in
a subprocess with one thread and a timeout of its own: the net smoke's
two-party leg over loopback TCP, traced (its trace passes
``scripts/trace_check.py``, and its revealed output and per-tag wire
ledger equal the JAX package's wire-v2 session on the same seed and
model, with no tolerance), the reduced-architecture smoke, the lint
entry point, and ``--device cuda`` refused where no card is.

The programs run at once, while the JAX session computes the reference
in this process. The net smoke's gateway pass and the chaos sweep (about
a minute a seed on one CPU thread) run in CI
(``.github/workflows/ci_torch.yml``) and on the card (``chip_smoke.py``);
``tests/test_torch_faults.py`` sweeps the same fault plans through the
port's ``ResilientClient`` and ``PitGateway``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1")
SMOKES = ("net_smoke_torch", "chaos_smoke_torch", "smoke_models_torch")

#: the net smoke's two-party leg, traced: argv = scripts dir, trace, result
LEG = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import net_smoke_torch as m
from repro_torch import obs
tracer = obs.enable()
model, x = m.model_and_input("cpu")
leg = m.two_party(model, x, "cpu")
obs.disable()
tracer.export(sys.argv[2])
with open(sys.argv[3], "w") as f:
    json.dump({"y": np.asarray(leg["y"]).tolist(),
               "negotiated_version": leg["negotiated_version"],
               "ledger": leg["ledger"]}, f)
"""


def _popen(*args):
    return subprocess.Popen([sys.executable, *map(str, args)], env=ENV,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _run(*args, timeout):
    return _wait(_popen(*args), timeout)


def _ok(proc):
    assert proc.returncode == 0, \
        f"rc {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"


def _script_module(name):
    """A script's module-level names (its ``main`` is not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_session(m):
    """The smoke's model and input from the same seed through the JAX
    package's in-process wire-v2 session."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.config import PrivacyConfig
    from repro.core.engine import PrivateTransformer, random_weights

    rng = np.random.default_rng(0)
    model = PrivateTransformer(PrivacyConfig(**m.PCFG), m.D, m.HEADS, m.DFF,
                               random_weights(rng, m.D, m.DFF, 1), seed=0)
    x = rng.normal(0, 1, (m.S, m.D))
    sess = model.compile_session(m.S, impl="ref", wire_version=2)
    y = sess.run(x, sess.preprocess(1)[0])
    return {"y": np.asarray(y),
            "offline_by_tag": dict(sess.stats.channel_offline.by_tag),
            "online_by_tag": dict(sess.stats.channel_online.by_tag)}


@pytest.fixture(scope="module")
def smokes(tmp_path_factory):
    """Every program of this file, started at once, and the JAX reference
    computed here while they run; each test reads its part."""
    import torch

    d = tmp_path_factory.mktemp("net_smoke")
    procs = {
        "leg": (_popen("-c", LEG, SCRIPTS, d / "trace.json",
                       d / "result.json"), 300),
        "models": (_popen(SCRIPTS / "smoke_models_torch.py", "--device",
                          "cpu", "--arch", "llama3.2-1b", "--arch",
                          "olmoe-1b-7b"), 180),
        "lint": (_popen(SCRIPTS / "lint_torch.py", "--secretflow",
                        "--baseline",
                        "src/repro_torch/analysis/baseline.json"), 120)}
    if not torch.cuda.is_available():
        procs.update({s: (_popen(SCRIPTS / f"{s}.py", "--device", "cuda"),
                          120) for s in SMOKES})
    try:
        ref = _reference_session(_script_module("net_smoke_torch"))
    finally:
        done = {k: _wait(p, timeout=t) for k, (p, t) in procs.items()}
    return {"dir": d, "ref": ref, **done}


def test_net_smoke_traced_passes_trace_check(smokes):
    _ok(smokes["leg"])
    check = _run(SCRIPTS / "trace_check.py", smokes["dir"] / "trace.json",
                 timeout=60)
    _ok(check)
    assert "trace_check: ok" in check.stdout


def test_net_smoke_reveals_the_reference_wire_v2_session(smokes):
    _ok(smokes["leg"])
    got = json.loads((smokes["dir"] / "result.json").read_text())
    ref = smokes["ref"]
    assert np.array_equal(np.asarray(got["y"]), ref["y"])
    assert got["negotiated_version"] == 2
    led = got["ledger"]
    assert led["offline_by_tag"] == ref["offline_by_tag"]
    assert led["online_by_tag"] == ref["online_by_tag"]
    assert led["rounds_after_coalescing"] < led["raw_messages"]


def test_smoke_models_two_architectures(smokes):
    _ok(smokes["models"])
    assert smokes["models"].stdout.count("PASS ") == 2


def test_lint_entry_point_secretflow_clean(smokes):
    _ok(smokes["lint"])


@pytest.mark.parametrize("script", SMOKES)
def test_cuda_without_a_card_is_refused(smokes, script):
    if script not in smokes:
        pytest.skip("a card is present: --device cuda would run the smoke")
    proc = smokes[script]
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
