"""protocol.encode_s.online: per request, the seconds inside the program's
``gc_online.encode`` spans in which the device ran nothing: ``gc_online``
packing the share words into bits, the garbler's encoding, the OT label
choice and the constant wires' labels. Needs the device trace; None where
the program records no such span."""

NAMES = ("gc_online.encode",)


def read(v):
    if v.spans is None or not any(s.name in NAMES for s in v.spans):
        return None
    return v.host_self_idle_s(NAMES, ())
