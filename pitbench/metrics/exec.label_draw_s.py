"""exec.label_draw_s: per request, the seconds inside the program's
``garble.draw`` spans in which the device ran nothing: ``garble.garble``
drawing R and the source zero-labels on the host's generator until they
sit on the device. Needs the device trace; None where the program records
no such span."""

NAMES = ("garble.draw",)


def read(v):
    if v.spans is None or not any(s.name in NAMES for s in v.spans):
        return None
    return v.host_self_idle_s(NAMES, ())
