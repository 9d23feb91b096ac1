"""The five internal phases' share of their roofline: the sum of their
bounds (``work.phase_work`` of lat, uvw, tke, tracer and mom as the options
run them) over the summed device time of the phase kernels."""

from pombench import work

LAYER = "phases"
UNIT = "%"
MOVES = "gpts_per_s"
KERNELS = ("k_lat_tile<", "k_uvw_tile<", "k_tke_tile<", "k_tracer_tile<",
           "k_tracer_edge<", "k_mpdata_tile<", "k_mom_tile<", "k_mom_edge<")


def read(trace):
    ks = trace.kernels(KERNELS)
    if not ks or trace.steps <= 0:
        return None
    nl = trace.namelist
    bound = sum(work.bound_s(*work.phase_work(p, **work.shape_of(nl),
                                              **work.options_of(nl)),
                             nl["dtype"]) for p in work.PHASES)
    spent = sum(k.end_us - k.start_us for k in ks) / 1e6
    return 100.0 * bound * trace.steps / spent
