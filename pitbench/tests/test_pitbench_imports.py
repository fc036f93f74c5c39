"""The import boundary, in a fresh process: the reference loads NumPy and
nothing of the program; the harness, its readers, the control and the
program modules a run drives load no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole: the port,
``repro_torch``, is what the harness drives)."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pitbench_tiny as tiny

PROBE = textwrap.dedent('''
    import json, sys
    sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]

    def tops():
        return sorted({m.split(".")[0] for m in sys.modules})

    import pitbench.reference.gc_ops, pitbench.reference.compare
    after_reference = tops()
    from pitbench import control, harness, trace, workload, yardstick
    for m in json.load(open(sys.argv[1] + "/BENCHMARK.json"))["per_layer"]:
        harness.reader(m["name"])
    for m in json.load(open(sys.argv[1] + "/BENCHMARK.json"))["end_to_end"]:
        harness.reader(m["name"])
    import repro_torch.core.protocol, repro_torch.core.session
    import repro_torch.core.garble, repro_torch.core.plan
    import repro_torch.kernels.level_eval.level_eval
    print(json.dumps({"reference": after_reference, "all": tops()}))
''')


def test_no_jax_nor_the_jax_package_and_a_reference_free_of_the_program():
    got = subprocess.run([sys.executable, "-c", PROBE, str(tiny.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    mods = json.loads(got.stdout.strip().splitlines()[-1])
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    assert not forbidden & set(mods["all"]), mods["all"]
    assert "repro_torch" in mods["all"]
    assert not {"repro_torch", "torch"} & set(mods["reference"]), \
        mods["reference"]
    assert "numpy" in mods["reference"]
