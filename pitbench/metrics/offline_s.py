"""offline_s: offline seconds per request, all offline time in the window
over the requests completed (host clock; each part ends in a device
synchronise)."""


def read(v):
    return v.phase_s("offline")
