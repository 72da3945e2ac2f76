"""The port's bench (``dvbs2rx_tpu_torch.bench``), its two tools and
``FeedForwardSync.step``, on the CPU.

- ``FeedForwardSync.step`` (single stream) against the JAX ``step``, two
  blocks chained from the fresh state, on the multi-window (n >= 16,384)
  and single-window paths; and ``step_batched`` at S = 16 segments against
  the JAX ``_step_impl`` vmapped per channel (the form ``bench.py``'s
  front end times), chained the same way. Tolerances as
  ``tests/test_torch_frontend.py``: ``consumed`` and ``initialized``
  exact, ``tau``/``rate`` within rtol 1e-5, symbols within atol 1e-4.
- Each section's stimulus function against ``bench.py``'s inline code with
  the JAX ``Transmitter`` (copied below, at short frames): symbols exact,
  pulse-shaped waves within 1e-6 of their largest magnitude (both use
  ``np.convolve`` on the same taps).
- The group + FEC section at C = 2, F = 2, short frames: the same kbytes,
  ``ldpc_iters`` and BCH errors as the JAX ``BatchedPipeline.step`` on the
  same inputs.
- The sustained section's TS rule (a consecutive run of the stimulus
  period's packets) and the front end's check (the plain matched filter
  on the step's tracker output, the tracker on the CPU) reject a dropped
  packet, a symbol off by 1e-4 of the RMS, a wrong ``consumed`` or ``tau``.
- ``main`` as a CPU rehearsal ends on a line that holds every key of
  ``bench.py``'s ``_HEADLINE_KEYS`` (none is dropped) and every section's
  ``_ok`` true, and exits 0; a section that raises leaves ``<name>_error``
  and the run exits 1, as does a section skipped for the budget.
- ``tools/torch_microbench.py`` and ``tools/torch_scaling_bench.py`` at
  tiny sizes on the CPU.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops.ffsync import FeedForwardSync as JFFSync
from dvbs2rx_tpu.parallel.batch import BatchedPipeline as JBatchedPipeline
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.spec import pi2_bpsk as jpi2
from dvbs2rx_tpu.spec.pls import make_pls as jmake_pls
from dvbs2rx_tpu.spec.pls import parse_pls as jparse_pls
from dvbs2rx_tpu.tx import Transmitter as JTransmitter
from dvbs2rx_tpu.tx import TxConfig as JTxConfig
from dvbs2rx_tpu.tx import awgn_channel
from dvbs2rx_tpu.tx.vcm import VCMTransmitter as JVCMTransmitter

from dvbs2rx_tpu_torch import bench
from dvbs2rx_tpu_torch.ops import cplx
from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync, FFSyncState
from dvbs2rx_tpu_torch.parallel.batch import BatchedPipeline
from dvbs2rx_tpu_torch.rx.receiver import RxConfig

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
# bench.py's _HEADLINE_KEYS: the port drops none of them
BENCH_PY_HEADLINE_KEYS = (
    "frontend_msps", "group_fec_msps", "ldpc_iters", "post_fec_ber",
    "sustained_msps", "sustained_device_msps", "sustained_scan_msps",
    "sustained_ok", "sustained_bch_errors",
    "vcm_sustained_msps", "vcm_step_ms", "vcm_ok", "vcm_frames_ratio",
    "vcm_bch_errors", "vcm_warm_bch_errors",
    "acm_msps_per_stream", "acm_msps_c8", "acm_c8_vs_serial",
    "elapsed_s",
)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def waveform():
    """Short QPSK 1/2 frames at 12 dB, delayed by 0.37 sample."""
    tx = JTransmitter(JTxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (120, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 12.0, sps=2, seed=1)
    return (iq[1:] * 0.63 + iq[:-1] * 0.37).astype(np.complex64)


def _assert_state(new, jnew):
    np.testing.assert_array_equal(new.initialized.numpy(),
                                  np.asarray(jnew.initialized))
    np.testing.assert_allclose(new.tau.numpy(), np.asarray(jnew.tau),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.rate.numpy(), np.asarray(jnew.rate),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("n_out", [8192, 4000])
def test_ffsync_single_stream_step_matches_jax(waveform, n_out):
    jsync = JFFSync(sps=2)
    sync = FeedForwardSync(sps=2, device="cpu")
    n = 2 * n_out + sync.history()
    jst, st = jsync.init_state(), sync.init_state()
    assert st.tau.shape == () and st.initialized.dtype == torch.int32
    pos = 0
    for _ in range(2):                   # fresh, then the carried state
        x = cplx.from_np(waveform[pos: pos + n])
        jst, jsyms, jcons = jsync.step(jst, x, n_out)
        st, syms, cons = sync.step(st, x, n_out)
        assert syms.shape == (n_out, 2) and cons.shape == ()
        assert int(cons) == int(jcons)
        np.testing.assert_allclose(syms.numpy(), np.asarray(jsyms), rtol=0,
                                   atol=1e-4)
        _assert_state(st, jst)
        pos += int(cons)


def test_step_batched_matches_vmapped_step_impl(waveform):
    """bench.py's front end: ``_step_impl`` vmapped per channel, S = 16."""
    C, n_out = 2, 8192
    jsync = JFFSync(sps=2)
    sync = FeedForwardSync(sps=2, device="cpu")
    assert sync.segments(n_out) == 16
    n = 2 * n_out + sync.history() + 64
    x = np.stack([cplx.from_np(waveform[o: o + n]) for o in (0, 3001)])
    jst = jax.tree.map(lambda v: jnp.stack([v] * C), jsync.init_state())
    st = sync.init_state(C)
    fe = jax.jit(jax.vmap(lambda a, b: jsync._step_impl(a, b, n_out)))
    for _ in range(2):                   # chained by the timing state
        jst, jsyms, jcons = fe(jst, jnp.asarray(x))
        st, syms, cons = sync.step_batched(st, torch.from_numpy(x), n_out)
        np.testing.assert_array_equal(cons.numpy(), np.asarray(jcons))
        np.testing.assert_allclose(syms.numpy(), np.asarray(jsyms), rtol=0,
                                   atol=1e-4)
        _assert_state(st, jst)
    assert isinstance(st, FFSyncState)


def test_pi2_bpsk_demapper_matches_jax():
    rng = np.random.default_rng(5)
    syms = (rng.normal(size=(4, 90)) + 1j * rng.normal(size=(4, 90))).astype(
        np.complex64)
    tool = _tool("torch_microbench")
    np.testing.assert_array_equal(tool.derotate_bpsk(syms),
                                  jpi2.derotate_bpsk(syms))
    np.testing.assert_array_equal(tool.demap_bpsk(syms),
                                  jpi2.demap_bpsk(syms))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ---- bench.py's inline stimulus code with the JAX Transmitter, at short
# frames (bench.py:784-797, 465-485, 598-608, 191-215)


def _jax_group_fec(F=2, fs="short", ESN0_DB=6.0):
    tx = JTransmitter(JTxConfig(modcod="qpsk1/2", frame_size=fs))
    L = tx.cfg.pls_info.plframe_len
    rng = np.random.default_rng(0)
    n_pkts = ((F + 2) * tx.df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    syms = tx.modulate_ts(pkts.reshape(-1))[: (F + 1) * L + 91]
    esn0 = 10 ** (ESN0_DB / 10)
    n0 = 1.0 / esn0
    noisy = syms + (
        rng.normal(0, np.sqrt(n0 / 2), (syms.size, 2)).astype(np.float32)
        @ np.array([1, 1j], dtype=np.complex64)
    )
    return pkts, noisy.astype(np.complex64)


def _jax_vcm(n_fe, fs="short", esn0_db=13.0, sps=2):
    pls_a = jmake_pls(4, fs == "short", True)     # qpsk1/2, pilots
    pls_b = jmake_pls(12, fs == "short", True)    # 8psk3/5, pilots
    vtx = JVCMTransmitter([
        JTxConfig(modcod="qpsk1/2", frame_size=fs, pilots=True),
        JTxConfig(modcod="8psk3/5", frame_size=fs, pilots=True),
    ])
    pair_syms = (jparse_pls(pls_a).plframe_len
                 + jparse_pls(pls_b).plframe_len)
    n_pairs = max(2, -(-n_fe // (pair_syms * sps)) + 1)
    rng = np.random.default_rng(11)
    df_bytes = (vtx.txs[0].df_bytes + vtx.txs[1].df_bytes)
    n_pkts = (n_pairs * df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    syms = vtx.modulate_ts(pkts.reshape(-1), [0, 1])[: n_pairs * pair_syms]
    assert syms.size == n_pairs * pair_syms, "stimulus under-filled"
    wave3 = vtx.txs[0].pulse_shape(np.tile(syms, 3))
    period = n_pairs * pair_syms * sps
    mid = wave3[period: 2 * period]
    esn0 = 10 ** (esn0_db / 10)
    noise = rng.normal(0, np.sqrt(sps / esn0 / 2), (period, 2))
    wave = (mid + noise @ np.array([1, 1j])).astype(np.complex64)
    return syms, wave, pair_syms


def _jax_acm(F0=4, fs="short", esn0_db=6.0):
    tx = JTransmitter(JTxConfig(modcod="qpsk1/2", frame_size=fs))
    rng = np.random.default_rng(3)
    n_pkts = ((F0 + 3) * tx.df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    syms = tx.modulate_ts(pkts.reshape(-1))
    esn0 = 10 ** (esn0_db / 10)
    noisy = (
        syms + rng.normal(0, np.sqrt(1 / esn0 / 2), (syms.size, 2))
        @ np.array([1, 1j])
    ).astype(np.complex64)
    return noisy


def _jax_sustained(F=2, fs="short", esn0_db=6.0, rolloff=0.2):
    T_WRAP = 2
    txc = JTxConfig(modcod="qpsk1/2", frame_size=fs, sps=2, rolloff=rolloff)
    tx = JTransmitter(txc)
    frame_len = tx.cfg.pls_info.plframe_len
    per_frames = T_WRAP * F
    rng = np.random.default_rng(7)
    n_pkts = (per_frames * tx.df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    syms = tx.modulate_ts(pkts.reshape(-1))[: per_frames * frame_len]
    assert syms.size == per_frames * frame_len, "stimulus under-filled"
    wave3 = tx.pulse_shape(np.tile(syms, 3))
    period = per_frames * frame_len * 2
    mid = wave3[period: 2 * period]
    esn0 = 10 ** (esn0_db / 10)
    noise = rng.normal(0, np.sqrt(2 / esn0 / 2), (period, 2))
    wave = (mid + noise @ np.array([1, 1j])).astype(np.complex64)
    return pkts, syms, wave


def test_stimuli_match_bench_py():
    pkts, noisy = _jax_group_fec()
    _, got_pkts, got = bench.group_fec_stimulus(2, "short")
    np.testing.assert_array_equal(got_pkts, pkts)
    np.testing.assert_array_equal(got, noisy)

    n_fe = 2 * 2 * 8190 + 39        # a short-frame stream's n_in + history
    syms, wave, pair = _jax_vcm(n_fe)
    got_syms, got_wave, got_pair = bench.vcm_stimulus(n_fe, "short")
    assert got_pair == pair
    np.testing.assert_array_equal(got_syms, syms)
    _close(got_wave, wave)

    _, got = bench.acm_stimulus(4, "short")
    np.testing.assert_array_equal(got, _jax_acm())

    pkts, syms, wave = _jax_sustained()
    _, got_pkts, got_syms, got_wave = bench.sustained_stimulus(2, "short")
    np.testing.assert_array_equal(got_pkts, pkts)
    np.testing.assert_array_equal(got_syms, syms)
    _close(got_wave, wave)


def test_group_fec_section_matches_jax_pipeline():
    C, F = 2, 2
    rec = bench.measure_group_fec(C, F, device="cpu", frame_size="short")
    tx, pkts, noisy = bench.group_fec_stimulus(F, "short")
    symbols = np.stack([noisy] * C)
    kw = dict(modcod="qpsk1/2", frame_size="short", fec_batch=C * F)
    ours = BatchedPipeline(RxConfig(**kw), C, F, device="cpu")
    ref = JBatchedPipeline(JRxConfig(**kw), n_channels=C, frames_per_step=F)
    h, p = ours.frame_inputs_from_symbols(symbols)
    kb, _, st = ours.step(torch.from_numpy(h), torch.from_numpy(p), True)
    kbj, _, stj = ref.step(jnp.asarray(h), jnp.asarray(p), jnp.asarray(True))
    np.testing.assert_array_equal(kb.numpy(), np.asarray(kbj))
    assert rec["ldpc_iters"] == int(st["ldpc_iters"]) == int(
        stj["ldpc_iters"])
    assert rec["bch_frame_errors"] == int(st["bch_errors"]) == int(
        stj["bch_errors"]) == 0
    assert rec["post_fec_ber"] == 0.0 and rec["group_fec_ok"]


def test_sustained_ts_check_takes_only_consecutive_runs():
    period = np.random.default_rng(1).integers(0, 256, (5, 188),
                                               dtype=np.uint8)
    seq = period[[3, 4, 0, 1, 2, 3, 4, 0]]
    assert bench._cyclic_run(seq.reshape(-1), period) == 8
    assert bench._cyclic_run(np.delete(seq, 4, axis=0).reshape(-1),
                             period) == -1
    assert bench._cyclic_run(seq.reshape(-1)[:-1], period) == -1
    assert bench._cyclic_run(np.zeros(0, np.uint8), period) == 0


@pytest.mark.parametrize("fault", [None, "symbols", "consumed", "tau"])
def test_frontend_check_catches_a_wrong_filter_or_tracker(fault):
    C, n_out = 2, 2048
    sync = FeedForwardSync(sps=2, device="cpu")
    n = 2 * n_out + sync.history() + 64
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(C, n, 2)).astype(np.float32))
    state = sync.init_state(C)
    new, syms, consumed = sync.step_batched(state, x, n_out)
    if fault == "symbols":      # one symbol off by 1e-4 of the RMS
        syms = syms.clone()
        syms[1, 100, 0] += 1e-4 * float(syms.square().mean().sqrt())
    elif fault == "consumed":
        consumed = consumed + 2
    elif fault == "tau":
        new = FFSyncState(new.tau + 0.01, new.rate, new.initialized)
    ok, found = bench._frontend_check(
        sync, FeedForwardSync(sps=2, device="cpu"), state, x, n_out,
        (new, syms, consumed))
    assert ok == (fault is None), found


REHEARSAL = ["--device", "cpu", "--frame-size", "short", "--channels", "2",
             "--steps", "2"]


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_rehearsal_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "bench.json"
    monkeypatch.setattr(bench, "FULL_RECORD_PATH", out)
    assert bench.main(REHEARSAL) == 0
    head = _last_line(capsys)
    missing = [k for k in BENCH_PY_HEADLINE_KEYS if k not in head]
    assert not missing, missing
    assert all(head[f"{s}_ok"] is True for s in bench.SECTIONS), head
    assert not [k for k in head if k.endswith(("_error", "_skipped"))]
    assert head["device"] == "cpu" and head["value"] > 0
    detail = json.loads(out.read_text())["detail"]
    for key in ("t_group_fec_s", "frontend_msps", "acm_t_fec_s",
                "h2d_msps_per_channel", "vcm_sustained_msps",
                "vcm_step_ms", "sustained_msps", "sustained_device_msps",
                "sustained_scan_msps"):
        lo, hi = detail[key + "_min"], detail[key + "_max"]
        assert lo * (1 - 1e-9) <= detail[key] <= hi * (1 + 1e-9), key
    assert detail["sustained_steps"] == detail["vcm_steps"] == 2
    assert detail["sustained_bch_errors"] == detail["acm_bch_errors"] == 0
    for dropped in ("ldpc_impl", "mf_precision", "dispatch_latency_s"):
        assert dropped not in detail


def _record(prefix, value):
    return lambda *a, **k: {f"{prefix}_msps": value, f"{prefix}_ok": True}


@pytest.mark.parametrize("broken", ["acm", "group_fec"])
def test_a_section_that_raises_fails_the_run(tmp_path, monkeypatch, capsys,
                                             broken):
    monkeypatch.setattr(bench, "FULL_RECORD_PATH", tmp_path / "b.json")
    fns = {"group_fec": "measure_group_fec", "frontend": "measure_frontend",
           "vcm": "measure_vcm", "acm": "measure_acm",
           "sustained": "measure_sustained"}
    for name, fn in fns.items():
        monkeypatch.setattr(bench, fn, _record(name, 100.0))

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(bench, fns[broken], boom)
    assert bench.main(REHEARSAL) == 1
    head = _last_line(capsys)
    assert head[f"{broken}_error"] == "RuntimeError: kernel launch failed"
    assert head[f"{broken}_ok"] is False
    others = [s for s in bench.SECTIONS if s != broken]
    assert all(head[f"{s}_ok"] for s in others)    # the rest still ran
    assert (head["value"] is None) == (broken == "group_fec")


def test_a_section_skipped_for_the_budget_fails_the_run(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setattr(bench, "FULL_RECORD_PATH", tmp_path / "b.json")
    for name, fn in (("group_fec", "measure_group_fec"),
                     ("frontend", "measure_frontend")):
        monkeypatch.setattr(bench, fn, _record(name, 100.0))
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    assert bench.main(REHEARSAL) == 1
    head = _last_line(capsys)
    assert head["value"] == pytest.approx(50.0)
    for name in ("vcm", "acm", "sustained"):
        assert "budget exhausted" in head[f"{name}_skipped"]
        assert head[f"{name}_ok"] is False


def test_microbench_on_the_cpu():
    out = _tool("torch_microbench").main(
        ["--device", "cpu", "--batch", "64", "--bch-batch", "2"])
    assert out["plsc_soft_decode"]["accuracy"] == 1.0
    assert out["bch_normal_t12"]["all_corrected"] is True
    assert out["pi2_bpsk_numpy"]["ref_ns"] == {"map": 51.2, "demap": 55.7}


def test_scaling_bench_on_cpu_meshes(tmp_path):
    tool = _tool("torch_scaling_bench")
    rec = tool.pipeline_main(8, 1, device="cpu")
    assert [r["devices"] for r in rec["table"]] == [1, 2, 4, 8]
    assert rec["devices"] == ["cpu"] * 8 and rec["distinct"] is False
    assert all(r["bch_errors"] == 0 for r in rec["table"])
    out = tmp_path / "scaling.json"
    rec = tool.stream_main(1, 2, device="cpu", out_path=str(out))
    assert json.loads(out.read_text()) == rec
    assert [r["channels"] for r in rec["table"]] == [1, 2, 4, 8]
    assert [r["core_oversubscription_floor"] for r in rec["table"]] == [
        1, 2, 4, 8]
    assert all(r["bch_errors"] == 0 for r in rec["table"])
