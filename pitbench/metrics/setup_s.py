"""setup_s: seconds from the start of the process to the first timed
request: imports, kernels, the protocol, netlists, level plans and
executors at the cell's instance counts, one untimed warm request."""


def read(v):
    return v.setup_s
