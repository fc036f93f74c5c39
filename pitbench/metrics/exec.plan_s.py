"""exec.plan_s: seconds of the program's ``gc_exec.get_executor`` spans in
set-up: building level plans and executors (a cached lookup adds
microseconds)."""


def read(v):
    if v.spans is None:
        return None
    got = [s.t1 - s.t0 for s in v.spans
           if s.name == "gc_exec.get_executor" and s.t1 <= v.setup_end]
    return sum(got) * 1e-9 if got else None
