"""circuit.and_M: millions of AND gates garbled per request, by the
protocol's ``Stats.gc_instances_ands`` counter over the window."""


def read(v):
    return v.and_gates / v.requests / 1e6
