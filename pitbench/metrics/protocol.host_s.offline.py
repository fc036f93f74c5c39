"""protocol.host_s.offline: per request, the seconds inside the program's
``gc_offline`` and ``layernorm_offline`` spans and the benchmark's span
around each slab's ``garble`` call, less their ``gc_exec.garble``
children, in which the device ran nothing: mask draws, metering and the
garbler's label draws on the offline path. Needs the device trace."""

NAMES = ("gc_offline", "layernorm_offline", "pitbench.garble")
CHILDREN = ("gc_exec.garble",)


def read(v):
    return v.host_self_idle_s(NAMES, CHILDREN)
