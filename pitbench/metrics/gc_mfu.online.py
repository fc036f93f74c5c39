"""gc_mfu.online: the least time the online GC work of a request could
take on the card (the yardstick's ``gc_phase_bound_s``: AND gates x
instances x EVAL_OPS against the int32 peak, or input labels, tables and
output labels each moved once against HBM), over online_s, in percent."""

from pitbench import yardstick


def read(v):
    if not v.on_card:
        return None
    bound, _ = yardstick.gc_phase_bound_s(v.work, garble=False)
    return 100.0 * bound / v.phase_s("online")
