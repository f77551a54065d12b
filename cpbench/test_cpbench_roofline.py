"""CPU tests: the least time of an exact sweep, and what the per-layer
readers take from a device trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from cpbench import roofline, spec
from cpbench.trace import Trace

FMRI = (225, 59, 200, 200)
SUBJECT = (225, 200, 200)


def test_fmri4d_sweep_is_bytes_bound_at_1268_us():
    assert roofline.sweep_bytes(FMRI, "float32") == 2 * 531_000_000 * 4
    assert roofline.least_sweep_s(FMRI, 10, "float32") == pytest.approx(1.268e-3, rel=1e-3)
    flop_s = roofline.sweep_flops(FMRI, 10) / roofline.PEAK_FLOPS["float32"]
    assert flop_s == pytest.approx(0.317e-3, rel=1e-3)  # the bytes bind


@pytest.mark.parametrize("rank,binds", [(40, "bytes"), (41, "operations")])
def test_crossover_to_operations_at_rank_40(rank, binds):
    t_bytes = roofline.sweep_bytes(FMRI, "float32") / roofline.HBM_BYTES_PER_S
    t_ops = roofline.sweep_flops(FMRI, rank) / roofline.PEAK_FLOPS["float32"]
    assert roofline.least_sweep_s(FMRI, rank, "float32") == max(t_bytes, t_ops)
    assert (t_bytes >= t_ops) == (binds == "bytes")


def test_fleet_batch_of_32_is_688_us_a_batch_sweep():
    assert roofline.least_sweep_s(SUBJECT, 10, "float32", batch=32) == pytest.approx(
        0.688e-3, rel=1e-3)
    assert roofline.least_sweep_s(SUBJECT, 10, "float32", batch=32) == pytest.approx(
        32 * roofline.least_sweep_s(SUBJECT, 10, "float32"))


def _trace():
    # window 0..100 µs; device busy 10..30 and 25..40 (merged 10..40) and 60..70
    device = [(10.0, 30.0, "k1"), (25.0, 40.0, "k2"), (60.0, 70.0, "k1")]
    host = [(0.0, 100.0, "cpbench.cp_als"), (2.0, 8.0, "aten::copy_"),
            (45.0, 58.0, "aten::linalg_pinv"), (46.0, 50.0, "cudaStreamSynchronize")]
    return Trace(wall_s=1e-4, lo_us=0.0, hi_us=100.0, device=device, host=host)


def test_trace_busy_gaps_and_breakdown():
    t = _trace()
    assert t.busy_s == pytest.approx(40e-6) and t.window_s == pytest.approx(100e-6)
    assert t.gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 100.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    named = dict((k, v) for k, v in b["idle_gaps"])
    assert named["aten::copy_"] == pytest.approx(10e-6)  # midpoint 5
    assert named["cudaStreamSynchronize"] == pytest.approx(20e-6)  # midpoint 50
    assert named["cpbench.cp_als"] == pytest.approx(30e-6)  # midpoint 85


def test_layer_readers_on_a_trace():
    run = SimpleNamespace(trace=_trace(), batched=False, counts={}, sweeps=4,
                          least_sweep_s=5e-6)
    assert spec.metric("device_idle.single")(run) == pytest.approx(60.0)
    assert spec.metric("device_roofline.single")(run) == pytest.approx(50.0)
    assert spec.metric("ops_per_sweep.single")(run) == pytest.approx(0.75)
    for name in ("device_idle.batched", "device_roofline.batched", "ops_per_sweep.batched"):
        assert spec.metric(name)(run) is None  # a single-tensor slice has no batch
    run.batched = True
    run.counts = {"step_host_s": 2.0, "execute_s": 1.5}
    assert spec.metric("device_idle.batched")(run) == pytest.approx(60.0)
    assert spec.metric("serve.overhead_share")(run) == pytest.approx(25.0)
    assert spec.metric("device_idle.single")(run) is None


def test_no_device_operation_reads_nothing():
    run = SimpleNamespace(trace=Trace(wall_s=1.0, lo_us=0.0, hi_us=1e6), batched=False,
                          counts={}, sweeps=4, least_sweep_s=1e-3)
    for name in ("device_idle.single", "device_roofline.single", "ops_per_sweep.single"):
        assert spec.metric(name)(run) is None
