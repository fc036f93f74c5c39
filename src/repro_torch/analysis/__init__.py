"""Static checks of the port's netlists (structural verifier)."""

from repro_torch.analysis.netcheck import (
    NetlistError,
    verify_netlist,
    verify_netlist_strict,
)

__all__ = ["NetlistError", "verify_netlist", "verify_netlist_strict"]
