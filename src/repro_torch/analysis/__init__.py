"""Static analysis for the port: netlist dataflow + protocol linters.

Two pillars, one CLI (``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.netcheck` — structural verification and
  dataflow passes (constant propagation, dead-gate/dead-wire detection,
  CSE duplicate detection, level histograms) over
  :class:`repro_torch.core.netlist.Netlist`. Its counters feed
  ``Netlist.stats()`` / ``LevelPlan.stats()``.
* :mod:`repro_torch.analysis.secretflow` /
  :mod:`repro_torch.analysis.jit_hygiene` — AST linters over the
  protocol sources: secret-typed values (labels, FreeXOR delta, masks,
  shares) must not reach a transport send, log call or exception message
  except through an approved masking/opening API; protocol paths must
  not draw from a global RNG.

Findings diff against the port's checked-in baseline
(``src/repro_torch/analysis/baseline.json``) so CI fails only on *new*
findings; see :mod:`repro_torch.analysis.report`. The port of the JAX
package's ``analysis`` package.
"""

from repro_torch.analysis.report import Baseline, Finding  # noqa: F401
from repro_torch.analysis.netcheck import (  # noqa: F401
    NetlistError,
    analyze_netlist,
    dataflow_summary,
    verify_netlist,
    verify_netlist_strict,
)
