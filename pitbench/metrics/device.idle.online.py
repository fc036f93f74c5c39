"""device.idle.online: the share of the online parts' wall time in which no
operation ran on the device, from the profiler's trace, in percent."""


def read(v):
    return v.idle_share("online")
