"""gc_mfu.offline: the least time the offline GC work of a request could
take on the card (the yardstick's ``gc_phase_bound_s``: AND gates x
instances x GARBLE_OPS against the int32 peak, or labels and tables each
moved once against HBM), over offline_s, in percent."""

from pitbench import yardstick


def read(v):
    if not v.on_card:
        return None
    bound, _ = yardstick.gc_phase_bound_s(v.work, garble=True)
    return 100.0 * bound / v.phase_s("offline")
