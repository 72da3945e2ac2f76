"""The piloted 16APSK cell rehearsed on the CPU at 2 channels and short
FECFRAMEs (16APSK 3/4 with pilots kept): a sound run comes out correct,
the TF32 control and ``ldpc_off`` come out not correct; and each of the
cell's per-layer metrics reads a finite value from a synthetic trace view
at the cell's geometry."""

import math

import pytest

from rxbench import spec
from rxbench.run import ROOT, run_cell
from rxbench.tests._small import small_cell
from rxbench.trace import TraceView

CELL = "ccm-16apsk34-64ch-13db"
APSK = {"rx": {"modcod": "16apsk3/4", "pilots": True},
        "tx": [{"modcod": "16apsk3/4", "frame_size": "short",
                "pilots": True}]}
SEED = 2**31 + 1025
PEAKS = {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 1.672704e13}
# the cell's geometry: 64 channels, 2 piloted normal frames a step
GEOMETRY = {"channels": 64, "frames_per_step": 2, "n_in": 66_744,
            "n_out": 33_372, "history": 39, "frame_len": 16_686,
            "payload_len": 16_596, "n_ldpc": 64_800, "n_mod": 4,
            "xfec_len": 16_200, "header_syms": 90}


def _run(**kw):
    return run_cell(small_cell(CELL, APSK), SEED, kw.pop("seconds", 3.0),
                    device="cpu", **kw)


def test_the_cell_keeps_its_configuration():
    c = spec.cell(spec.load_bench(ROOT), CELL, ROOT)
    assert c.config["rx"]["modcod"] == "16apsk3/4"
    assert c.config["rx"]["pilots"] and c.config["reduced"] == []
    assert c.traffic["esn0_db"] == 13.0
    assert {m["name"] for m in c.per_layer} == {
        "apsk_step_busy_ms", "apsk_plsync_ms", "apsk_plsync_roofline_pct",
        "apsk_ldpc_ms", "apsk_ldpc_iters_per_frame",
        "apsk_ldpc_roofline_pct"}
    r = small_cell(CELL, APSK)
    assert r.config["rx"]["frame_size"] == "short" and r.config["channels"] \
        == 2 and r.config["tx"][0]["pilots"]


def test_sound_run():
    r = _run()
    assert r["correct"], r["limits"]
    assert r["failed"] == 0 and r["checked_frames"] > 0
    assert set(r["metrics"]) == {"rx_msps", "rx_latency_p95_ms", "setup_s"}


def test_control_fails():
    r = _run(control=True)
    assert not r["correct"]
    gap = r["limits"]["fe_sym_gap"]
    assert gap["value"] > 3 * gap["limit"], gap


def test_ldpc_off_fails():
    r = _run(rx_fault="ldpc_off", seconds=2.5)
    assert not r["correct"]
    assert r["limits"]["wrong_frames"]["value"] > 0


def _view(counters):
    """Two traced steps: the LDPC kernel 0.3 ms a step, the PL sync pair
    0.04 ms, glue beside them."""
    dev = [("void ldpc_layered_kernel<12, false>(signed char const*)", 0.0,
            600.0, "kernel"),
           ("plsync_stats_kernel", 600.0, 40.0, "kernel"),
           ("plsync_demap_kernel", 640.0, 40.0, "kernel"),
           ("void at::native::elementwise_kernel<128, 2>(int)", 700.0, 300.0,
            "kernel")]
    return TraceView([(dev, [], 2, [0])], ("ldpc*", "plsync_*"),
                     dict(GEOMETRY), counters, PEAKS)


def test_each_metric_reads_a_finite_value():
    # 256 frames at 4 iterations, every one converged
    v = _view({"stats.ldpc_frame_iters": 1024.0,
               "stats.ldpc_converged": 256.0})
    got = {m: spec.metric(m).read(v) for m in (
        "apsk_step_busy_ms", "apsk_plsync_ms", "apsk_plsync_roofline_pct",
        "apsk_ldpc_ms", "apsk_ldpc_iters_per_frame",
        "apsk_ldpc_roofline_pct")}
    assert all(x is not None and math.isfinite(x) for x in got.values()), got
    assert got["apsk_step_busy_ms"] == pytest.approx(0.49)   # 980 us busy
    assert got["apsk_ldpc_ms"] == pytest.approx(0.3)
    assert got["apsk_plsync_ms"] == pytest.approx(0.04)
    assert got["apsk_ldpc_iters_per_frame"] == 4.0
    # 226,800 edges x (17 x 1,024 + 3 x 256) int32 steps in 0.6 ms
    want = 100 * 226_800 * (17 * 1024 + 3 * 256) / 1.672704e13 / 600e-6
    assert got["apsk_ldpc_roofline_pct"] == pytest.approx(want, rel=1e-12)
    assert 0 < got["apsk_ldpc_roofline_pct"] <= 100
    # 33.7 MB a step at 3.35 TB/s in 0.04 ms
    nbytes = 128 * 16_596 * 8 + 64 * 3 * 720 + 128 * 64_800 + 64 * 16_200 * 8
    assert nbytes == 33_721_344
    assert got["apsk_plsync_roofline_pct"] == pytest.approx(
        100 * nbytes / 3.35e12 / 40e-6, rel=1e-12)


def test_without_the_counters_or_the_code_nothing_is_read():
    v = _view({})
    assert spec.metric("apsk_ldpc_iters_per_frame").read(v) is None
    assert spec.metric("apsk_ldpc_roofline_pct").read(v) is None
    v = _view({"stats.ldpc_frame_iters": 128.0,
               "stats.ldpc_converged": 128.0})
    v.geometry["n_mod"] = 2                     # the QPSK cell's
    assert spec.metric("apsk_ldpc_roofline_pct").read(v) is None
    assert spec.metric("apsk_ldpc_roofline_pct").frame_edges() == 226_800
