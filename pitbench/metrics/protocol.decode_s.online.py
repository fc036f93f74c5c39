"""protocol.decode_s.online: per request, the seconds inside the program's
``gc_online.decode`` spans in which the device ran nothing: ``gc_online``
decoding the output labels to bits and the bits to words. The span's
copy to the host waits for the walk; that wait is device time and is not
counted. Needs the device trace; None where the program records no such
span."""

NAMES = ("gc_online.decode",)


def read(v):
    if v.spans is None or not any(s.name in NAMES for s in v.spans):
        return None
    return v.host_self_idle_s(NAMES, ())
