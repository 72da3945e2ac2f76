"""The end-to-end statistics and the per-layer arithmetic: the tail is a
percentile over every call, each roofline's bytes equal a hand count at
the cells' shapes, and the trace reduction adds up."""

import numpy as np

from rxbench import spec
from rxbench.run import Window
from rxbench.trace import TraceView, bare_name, gaps, union_us

PEAKS = {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 1.672704e13}


def test_p95_over_every_call():
    # 100 calls: 94 at 10 ms and 6 at 50 ms. A median of chunks of 10
    # would read 10 ms; the 95th percentile of every call reads the tail.
    lat = np.array([0.010] * 94 + [0.050] * 6)
    w = Window(20.0, lat.size, 1, lat, 1.0)
    got = spec.end_to_end("rx_latency_p95_ms").read(w)
    assert abs(got - np.percentile(lat, 95) * 1e3) < 1e-9
    assert got > 10.0


def test_rate_counts_landed_calls():
    w = Window(20.0, 1000, 66_534_400, np.zeros(1000), 1.0)
    assert spec.end_to_end("rx_msps").read(w) == 1000 * 66_534_400 / 20 / 1e6


CCM = {"channels": 64, "frames_per_step": 2, "n_in": 129_960,
       "n_out": 64_980, "history": 39, "frame_len": 32_490,
       "payload_len": 32_400, "n_ldpc": 64_800, "n_mod": 2,
       "xfec_len": 32_400, "header_syms": 90}


def test_frontend_bytes_hand_count():
    m = spec.metric("frontend_roofline_pct")
    # 64 channels x 8 bytes x (129,960 in + 39 history + 64,980 out)
    assert m.step_bytes(CCM) == 64 * 8 * 194_979 == 99_829_248


def test_plsync_bytes_hand_count():
    m = spec.metric("plsync_roofline_pct")
    # 128 payloads of 32,400 symbols read, 64 x 3 headers of 90 read,
    # 128 x 64,800 int8 LLRs and 64 x 32,400 symbols written
    hand = (128 * 32_400 * 8 + 64 * 3 * 90 * 8 + 128 * 64_800
            + 64 * 32_400 * 8)
    assert m.ccm_step_bytes(CCM) == hand == 58_199_040


def _view(device, steps=2, patterns=("ldpc*", "plsync_*")):
    return TraceView([(device, [], steps, [0])], patterns, dict(CCM), {},
                     PEAKS)


def test_trace_reduction_adds_up():
    dev = [("void ldpc_layered_kernel<21, false>(signed char const*)", 0.0,
            100.0, "kernel"),
           ("plsync_stats_kernel", 50.0, 100.0, "kernel"),
           ("void at::native::elementwise_kernel<128, 2>(int)", 200.0, 30.0,
            "kernel"),
           ("Memcpy DtoH (Device -> Pinned)", 300.0, 20.0, "gpu_memcpy"),
           ("Memcpy DtoD (Device -> Device)", 330.0, 10.0, "gpu_memcpy")]
    v = _view(dev)
    assert v.span_us == 340.0
    assert v.busy_us == 150.0 + 30.0 + 20.0 + 10.0
    assert v.kernel_us(("ldpc*",)) == 100.0
    assert v.unmatched_us() == 40.0
    assert v.dtoh_us() == 20.0
    assert spec.metric("glue_ms").read(v) == 40.0 / 2 / 1e3
    assert spec.metric("fetch_ms").read(v) == 20.0 / 2 / 1e3
    idle = spec.metric("device_idle_pct").read(v)
    assert abs(idle - 100 * (1 - 210 / 340)) < 1e-9
    total = sum(d for _, _, d, _ in dev)
    assert v.kernel_us(("ldpc*", "plsync_*")) + v.unmatched_us() + \
        v.dtoh_us() == total
    b = v.breakdown()
    assert b["device_ops"][0][0] in ("ldpc_layered_kernel",
                                     "plsync_stats_kernel")
    assert len(b["idle_gaps"]) == 3


def test_roofline_share_from_bytes():
    us = 100.0                      # plsync time over the 2 steps
    dev = [("plsync_demap_kernel", 0.0, us, "kernel")]
    v = _view(dev)
    want = 100 * (58_199_040 / 3.35e12) / (us / 2 * 1e-6)
    got = spec.metric("plsync_roofline_pct").read(v)
    assert abs(got - want) < 1e-9


def test_nothing_to_read_gives_nothing():
    v = _view([("frontend_rotate_kernel", 0.0, 5.0, "kernel")])
    assert spec.metric("fec_tail_ms").read(v) is None
    assert spec.metric("ldpc_ms").read(v) is None
    v.peaks = None
    assert spec.metric("frontend_roofline_pct").read(v) is None


def test_helpers():
    assert bare_name("void ffsync_track_kernel<8>(float const*)") == \
        "ffsync_track_kernel"
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert gaps([(0, 2), (1, 3), (5, 6)]) == [(3, 5)]
