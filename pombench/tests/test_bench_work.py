"""The yardstick's counts at a small shape against a count by hand."""

import pytest

from pombench import work

IM, JM, KB = 8, 6, 5
N3, N2 = KB * IM * JM, IM * JM


def test_ext_work_by_hand():
    flops, nbytes = work.ext_work(IM, JM, 30, "float32")
    assert flops == 199 * 30 * N2
    assert nbytes == (48 * N2 + 6 * JM + 6 * IM + 1) * 4


@pytest.mark.parametrize("phase,r3,w3,n2,extra", [
    ("lat", 7, 5, 7, 2 * KB),
    ("uvw", 2, 3, 12, KB + KB * (2 * IM + 2 * JM - 4)),
    ("tke", 14, 8, 14, 4 * KB),
    ("tracer", 11, 5, 15, 4 * KB * (IM + JM) + 4 * KB),
    ("mom", 10, 4, 19, 2 * KB),
])
def test_phase_bytes_by_hand(phase, r3, w3, n2, extra):
    flops, nbytes = work.phase_work(phase, IM, JM, KB, "float64")
    assert nbytes == ((r3 + w3) * N3 + n2 * N2 + extra) * 8
    assert flops == work.PHASE_FLOPS[phase] * N3


def test_options_add_their_work():
    base = work.phase_work("tracer", IM, JM, KB, "float32")
    mp = work.phase_work("tracer", IM, JM, KB, "float32", nadv=2, nitera=2)
    assert mp[0] - base[0] == (2 * 110 + 90) * N3
    assert mp[1] - base[1] == 2 * N2 * 4
    lat = work.phase_work("lat", IM, JM, KB, "float32", npg=2)
    assert lat[0] == (280 + 60) * N3


def test_mpdata_and_step_by_hand():
    flops, nbytes = work.mpdata_work(IM, JM, KB, "float32", 3)
    assert flops == (3 * 110 + 2 * 90) * N3
    assert nbytes == (7 * N3 + 12 * N2 + 2 * KB) * 4
    flops, nbytes = work.step_work(IM, JM, KB, "float32")
    assert flops == 199 * 30 * N2 + 1005 * N3
    assert nbytes == (41 * N3 + 66 * N2 + 4 * KB) * 4


def test_bound_takes_the_larger():
    assert work.bound_s(67e12, 0.0, "float32") == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12, "float32") == pytest.approx(1.0)
    # config5's window: bound by operations, 0.3737 ms
    b = work.bound_s(*work.ext_work(2048, 2048, 30, "float32"), "float32")
    assert b == pytest.approx(0.37373e-3, rel=1e-4)
