"""device.idle.offline: the share of the offline parts' wall time in which no
operation ran on the device, from the profiler's trace, in percent."""


def read(v):
    return v.idle_share("offline")
