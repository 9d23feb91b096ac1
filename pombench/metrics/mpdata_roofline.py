"""MPDATA's tiled launch's share of its roofline: the bound of the nitera
upstream steps of T and S (``work.mpdata_work``) over the device time of
``k_mpdata_tile``."""

from pombench import work

LAYER = "MPDATA"
UNIT = "%"
MOVES = "gpts_per_s"
KERNELS = ("k_mpdata_tile<",)


def read(trace):
    ks = trace.kernels(KERNELS)
    nl = trace.namelist
    if not ks or trace.steps <= 0 or nl.get("nadv", 1) != 2:
        return None
    bound = work.bound_s(*work.mpdata_work(nl["im"], nl["jm"], nl["kb"],
                                           nl["dtype"], nl["nitera"]),
                         nl["dtype"])
    spent = sum(k.end_us - k.start_us for k in ks) / 1e6
    return 100.0 * bound * trace.steps / spent
