"""wire_MB: megabytes (1e6 B) both parties exchange per request, offline
and online, by the protocol's channel meter over the window."""


def read(v):
    return v.wire_bytes / v.requests / 1e6
