"""protocol.mask_s.offline: per request, the seconds inside the program's
``gc_offline.masks`` spans in which the device ran nothing: ``gc_offline``
drawing the output masks and making their encoding ``t - r``. Needs the
device trace; None where the program records no such span."""

NAMES = ("gc_offline.masks",)


def read(v):
    if v.spans is None or not any(s.name in NAMES for s in v.spans):
        return None
    return v.host_self_idle_s(NAMES, ())
