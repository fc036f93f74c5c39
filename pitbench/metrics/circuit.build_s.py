"""circuit.build_s: seconds of the program's ``circuit.build`` spans in
set-up: netlists generated by ``PiTProtocol.build_fn_circuit`` on a cache
miss (a cached netlist records no span). None where the program records
no such span."""


def read(v):
    if v.spans is None:
        return None
    got = [s.t1 - s.t0 for s in v.spans
           if s.name == "circuit.build" and s.t1 <= v.setup_end]
    return sum(got) * 1e-9 if got else None
