"""The per-layer readers on a made-up trace."""

import pytest

from pombench import trace as tr
from pombench import work
from pombench.metrics import reader

NL = dict(im=64, jm=32, kb=5, dtype="float32", isplit=30, nadv=2, nitera=2,
          npg=1)


def made_up(steps=4) -> tr.Trace:
    ops = [tr.Op("void (anonymous namespace)::k_window<float, 0>(x)", 0, 10,
                 True),
           tr.Op("void at::native::elementwise_kernel<x>", 12, 14, True),
           tr.Op("void (anonymous namespace)::k_tke_tile<float, 0>(x)", 14,
                 24, True),
           tr.Op("void (anonymous namespace)::k_mpdata_tile<float>(x)", 24,
                 30, True),
           tr.Op("Memcpy DtoH", 30, 31, False),
           tr.Op("void at::native::reduce_kernel<x>", 50, 60, True)]
    spans = [tr.Span("segment", 0, 40, 0.0),
             tr.Span("diagnostics", 40, 70, 0.0)]
    return tr.Trace(ops, spans, 100e-6, steps, NL, 2e-3)


def test_busy_and_idle():
    t = made_up()
    assert t.busy_s() == pytest.approx(39e-6)     # 0-10, 12-31, 50-60
    assert reader("device_idle_share").read(t) == pytest.approx(61.0)


def test_plain_kernels_per_step():
    assert reader("plain_kernels_per_step").read(made_up()) == 0.5


def test_rooflines():
    t = made_up()
    ext = work.bound_s(*work.ext_work(64, 32, 30, "float32"), "float32")
    assert reader("extwin_roofline").read(t) == pytest.approx(
        100 * ext * 4 / 10e-6)
    mp = work.bound_s(*work.mpdata_work(64, 32, 5, "float32", 2), "float32")
    assert reader("mpdata_roofline").read(t) == pytest.approx(
        100 * mp * 4 / 6e-6)
    ph = sum(work.bound_s(*work.phase_work(p, 64, 32, 5, "float32", nadv=2,
                                           nitera=2), "float32")
             for p in work.PHASES)
    assert reader("phases_roofline").read(t) == pytest.approx(
        100 * ph * 4 / 16e-6)


def test_step_mfu():
    least = work.bound_s(*work.step_work(64, 32, 5, "float32", 30, nadv=2,
                                         nitera=2), "float32")
    assert reader("step_mfu").read(made_up()) == pytest.approx(
        100 * least / 2e-3)


def test_readers_find_nothing():
    t = tr.Trace([], [], 1.0, 4, dict(NL, nadv=1), 0.0)
    for name in ("extwin_roofline", "phases_roofline", "mpdata_roofline",
                 "device_idle_share", "plain_kernels_per_step", "step_mfu"):
        assert reader(name).read(t) is None


def test_breakdown_names_idle_gaps_by_span():
    b = tr.breakdown(made_up())
    assert b["device_ops"][0][0].startswith("void (anonymous namespace)")
    assert b["idle_gaps"][0] == ["diagnostics", pytest.approx(19e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
