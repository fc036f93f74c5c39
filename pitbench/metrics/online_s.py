"""online_s: online seconds per request, all online time in the window
over the requests completed (host clock; each part ends in a device
synchronise)."""


def read(v):
    return v.phase_s("online")
