"""protocol.host_s.online: per request, the seconds inside the program's
``gc_online`` and ``layernorm_online`` spans, less their
``gc_exec.evaluate`` children, in which the device ran nothing: the
protocol's own host work (bit packing, encoding, OT, label copies,
decoding) on the online path. Needs the device trace."""

NAMES = ("gc_online", "layernorm_online")
CHILDREN = ("gc_exec.evaluate",)


def read(v):
    return v.host_self_idle_s(NAMES, CHILDREN)
