"""The whole step's share of the chip's peak: the step's least time on an
H100 (``work.step_work``'s flops over the float peak or its compulsory
bytes over the HBM rate, whichever is larger) over the seconds a step took
in the run's untraced window (its seconds over its internal steps, the
diagnostics at the prints included)."""

from pombench import work

LAYER = "step"
UNIT = "%"
MOVES = "gpts_per_s"
KERNELS = ()


def read(trace):
    if not trace.step_s > 0:
        return None
    nl = trace.namelist
    least = work.bound_s(*work.step_work(
        **work.shape_of(nl), isplit=nl["isplit"], **work.options_of(nl)),
        nl["dtype"])
    return 100.0 * least / trace.step_s
