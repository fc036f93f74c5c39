"""kernel.garble_walk.roofline: the yardstick's least time of every
``garble_walk`` launched in the window (``walk_bound_s`` per walk:
records, labels and tables each moved once, or its Half-Gates' integer
operations) over the device time the profiler gives that kernel, in
percent. On the card the walk is the template ``walk_kernel<kGarble>``
of ``level_eval.cu``; its garble side is ``kGarble = true``."""

GARBLE = True
KERNEL = ("walk_kernel<true", "walk_kernel<(bool)1", "garble_walk")


def read(v):
    if v.device is None:
        return None
    dev = v.device.kernel_s(KERNEL)
    bound = sum(w["bound_s"] * w["calls"] for w in v.walks
                if w["garble"] == GARBLE)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev
