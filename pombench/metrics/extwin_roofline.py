"""The external window kernel's share of its roofline: the isplit substeps'
bound (``work.ext_work``: their operations, or the loop's operands read and
its carry written once) over the device time of the kernel's launches
(the window kernel and its per-step metrics launch)."""

from pombench import work

LAYER = "external loop"
UNIT = "%"
MOVES = "gpts_per_s"
KERNELS = ("k_window<", "k_metrics<")


def read(trace):
    ks = trace.kernels(KERNELS)
    if not ks or trace.steps <= 0:
        return None
    nl = trace.namelist
    bound = work.bound_s(*work.ext_work(nl["im"], nl["jm"], nl["isplit"],
                                        nl["dtype"]), nl["dtype"])
    spent = sum(k.end_us - k.start_us for k in ks) / 1e6
    return 100.0 * bound * trace.steps / spent
