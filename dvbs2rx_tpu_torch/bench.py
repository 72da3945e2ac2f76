"""Benchmark: steady-state IQ -> TS receiver throughput on one card.

    python -m dvbs2rx_tpu_torch.bench                  # on the card
    python -m dvbs2rx_tpu_torch.bench --device cpu --frame-size short \\
        --channels 2 --steps 2                         # a CPU rehearsal

Port of the root ``bench.py``: the same workloads, seeds and record keys,
over the port's engines. QPSK 1/2 FECFRAMEs (normal unless
``--frame-size short``), 64 channels, Es/N0 6 dB. Sections, in
``bench.py``'s order:

1. group + FEC (``measure_group_fec``): ``BatchedPipeline.step``, 64 ch x
   2 pilotless frames, seed 0: ``group_fec_msps``, ``ldpc_iters``,
   ``post_fec_ber`` (BBFRAME bytes against ``Transmitter.bbframes``) and
   ``bch_frame_errors``;
2. front end (``measure_frontend``): ``FeedForwardSync.step_batched`` at C
   = 64, 32,768 symbols a block, over the same noisy symbols, chained by
   threading the timing state: ``frontend_msps``. Then the headline
   ``iq_to_ts_throughput`` (both stages back to back on one card) against
   the reference's 2 Msps CPU operating point;
3. VCM (``measure_vcm``), 4. ACM (``measure_acm``), 5. sustained
   (``measure_sustained``), each under the wall-clock budget
   ``BENCH_BUDGET_S`` (default 1800 s from the start of ``main``).

Timing. A kernel-bound figure is the median of N timings of back-to-back
calls after warm-up (``time_ms``: CUDA events on the card, the host clock
on the CPU), with its spread kept as ``<key>_min`` and ``<key>_max``. The
sustained and VCM figures are end to end: the host clock over W chained
steps, beside the host synchronisations one step makes (``count_syncs``).

Output. ``emit`` writes the full record to ``build/bench_torch_latest.json``
and prints one compact JSON line per section, so the last line is always
the most complete. A section that raises leaves ``<name>_error`` and runs
on to the next; every section has a ``<name>_ok`` flag, and ``main``
exits non-zero after the last line when any section raised, failed its
integrity check or was skipped. Nothing falls back to the CPU: a kernel
that fails to build or launch raises in its section.
"""

import argparse
import gc
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ._build import launch_counts
from .ops import cplx
from .ops.crc8_dev import packet_validity
from .ops.ffsync import FeedForwardSync, FFSyncState
from .ops.fir_cuda import mf_segmented_plain
from .parallel.batch import BatchedPipeline
from .rx.receiver import ACMReceiver, RxConfig
from .rx.stream import StreamReceiver
from .rx.vcm_stream import VCMStreamReceiver
from .spec.bb_frame import BatchTSStitcher
from .spec.pls import make_pls, parse_pls
from .spec.scramblers import bb_derandomizer_bytes
from .tx import Transmitter, TxConfig
from .tx.vcm import VCMTransmitter
from .utils.runtime import resolve_device

# headline keys copied from the full record into the compact line
# (bench.py's _HEADLINE_KEYS) and every section's flag
HEADLINE_KEYS = (
    "frontend_msps", "group_fec_msps", "ldpc_iters", "post_fec_ber",
    "sustained_msps", "sustained_device_msps", "sustained_scan_msps",
    "sustained_ok", "sustained_bch_errors",
    "vcm_sustained_msps", "vcm_step_ms", "vcm_ok", "vcm_frames_ratio",
    "vcm_bch_errors", "vcm_warm_bch_errors",
    "acm_msps_per_stream", "acm_msps_c8", "acm_c8_vs_serial",
    "elapsed_s",
)
SECTIONS = ("group_fec", "frontend", "vcm", "acm", "sustained")
FULL_RECORD_PATH = (Path(__file__).resolve().parent.parent / "build"
                    / "bench_torch_latest.json")
REF_MSPS = 2.0        # the reference's real-time operating point: 1 Mbaud
                      # at 2 samples/symbol on an RTL-SDR host CPU
                      # (docs/support.md:53-61; BASELINE.md)
# the later sections' minimum wall-clock budget, seconds (bench.py's)
SECTION_MIN_BUDGET = {"vcm": 300, "acm": 180, "sustained": 240}
ESN0_DB = 6.0
FE_N_OUT = 32768      # front-end block, symbols
MF_TOL = 1e-5         # the front end's symbols against the plain matched
                      # filter, relative to their RMS (chip_smoke's)
TRACK_TOL = 1e-3      # the timing tracker against its CPU run: tau, and
                      # the drift over one block, in samples
ACM_F0, ACM_CB = 4, 8     # ACM frame group; channels of the batched stages
T_WRAP, T_SCAN = 2, 8     # sustained: stimulus period (steps); scan length


# ---------------------------------------------------------------- timing


def _runs(device):
    """Timings per figure: 20 on the card; 2 on the CPU, where a rehearsal
    checks the control flow and no time means anything."""
    return 20 if device.type == "cuda" else 2


def time_ms(fn, runs=20, warmup=2, per=10, device="cuda"):
    """(median, min, max) over ``runs`` timings of ``per`` back-to-back
    calls of fn(), divided by ``per``, after ``warmup`` calls, in ms. On the
    card by CUDA events: the host enqueues the next call while the card
    runs the last, so a short kernel's time does not include the host's
    launch latency (a call that reads back waits for its own work). On the
    CPU by the host clock."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        if cuda:
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        else:
            times.append((time.perf_counter() - t0) * 1e3 / per)
    return statistics.median(times), min(times), max(times)


def count_syncs(fn, device="cuda"):
    """fn()'s result and the host<->device synchronisations it made, by
    torch's sync debug mode (one warning per synchronising call); None
    for the count on the CPU, where there is no card to wait for."""
    if torch.device(device).type != "cuda":
        return fn(), None
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spread(rec, key, stats, scale=1.0):
    """rec[key] and rec[key_min], rec[key_max] from time_ms's (median,
    min, max) times ``scale``."""
    rec[key] = stats[0] * scale
    rec[key + "_min"] = stats[1] * scale
    rec[key + "_max"] = stats[2] * scale


def _rate_spread(rec, key, samples, ms):
    """rec[key] Msps of ``samples`` over the (median, min, max) ms: the
    slowest time gives the minimum rate."""
    rec[key] = samples / ms[0] / 1e3
    rec[key + "_min"] = samples / ms[2] / 1e3
    rec[key + "_max"] = samples / ms[1] / 1e3


def _nbytes(*objs):
    """Bytes of the tensors in ``objs`` (dicts and lists walked)."""
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, dict):
            n += _nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            n += _nbytes(*o)
    return n


def _peak_start(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_mib(device):
    """Peak device memory since ``_peak_start``, MiB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def _launches_since(before):
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()}


def _cyclic_run(ts, period):
    """The packets of ``ts`` (bytes) when they are a consecutive run of the
    periodic packet sequence ``period`` (q, 188), repeated; else -1."""
    if ts.size % 188:
        return -1
    out = ts.reshape(-1, 188)
    if out.shape[0] == 0:
        return 0
    k = np.flatnonzero((period == out[0]).all(axis=1))
    if k.size != 1:
        return -1
    idx = (k[0] + np.arange(out.shape[0])) % period.shape[0]
    return out.shape[0] if np.array_equal(out, period[idx]) else -1


def _packets(rng, df_bytes, n_frames):
    """bench.py's TS stimulus: whole packets for ``n_frames`` data fields
    plus two, random bytes after each 0x47."""
    n_pkts = (n_frames * df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    return pkts


# -------------------------------------------------------------- stimuli


def group_fec_stimulus(F=2, frame_size="normal", esn0_db=ESN0_DB):
    """bench.py:784-797 (seed 0): (Transmitter, packets, noisy frame-aligned
    symbols ((F+1) L + 91,) complex64, the same for every channel)."""
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size=frame_size))
    L = tx.cfg.pls_info.plframe_len
    rng = np.random.default_rng(0)
    pkts = _packets(rng, tx.df_bytes, F + 2)
    syms = tx.modulate_ts(pkts.reshape(-1))[: (F + 1) * L + 91]
    n0 = 1.0 / 10 ** (esn0_db / 10)
    noisy = syms + (
        rng.normal(0, np.sqrt(n0 / 2), (syms.size, 2)).astype(np.float32)
        @ np.array([1, 1j], dtype=np.complex64)
    )
    return tx, pkts, noisy.astype(np.complex64)


def vcm_stimulus(n_fe, frame_size="normal", esn0_db=13.0, sps=2):
    """bench.py:466-485 (seed 11): whole alternating piloted QPSK 1/2 /
    8PSK 3/5 frame pairs covering ``n_fe`` samples, cyclically pulse-shaped
    so the period wraps seamlessly, plus noise. Returns (symbols, wave
    (period,) complex64, symbols per pair)."""
    vtx = VCMTransmitter([
        TxConfig(modcod="qpsk1/2", frame_size=frame_size, pilots=True),
        TxConfig(modcod="8psk3/5", frame_size=frame_size, pilots=True),
    ])
    pair_syms = sum(t.cfg.pls_info.plframe_len for t in vtx.txs)
    n_pairs = max(2, -(-n_fe // (pair_syms * sps)) + 1)
    rng = np.random.default_rng(11)
    df_bytes = vtx.txs[0].df_bytes + vtx.txs[1].df_bytes
    pkts = _packets(rng, df_bytes, n_pairs)
    syms = vtx.modulate_ts(pkts.reshape(-1), [0, 1])[: n_pairs * pair_syms]
    if syms.size != n_pairs * pair_syms:
        raise RuntimeError("VCM stimulus under-filled")
    wave3 = vtx.txs[0].pulse_shape(np.tile(syms, 3))
    period = n_pairs * pair_syms * sps
    mid = wave3[period: 2 * period]
    esn0 = 10 ** (esn0_db / 10)
    noise = rng.normal(0, np.sqrt(sps / esn0 / 2), (period, 2))
    wave = (mid + noise @ np.array([1, 1j])).astype(np.complex64)
    return syms, wave, pair_syms


def acm_stimulus(F0=ACM_F0, frame_size="normal", esn0_db=ESN0_DB,
                 pilots=False):
    """bench.py:598-608 (seed 3): noisy QPSK 1/2 symbols of F0 + 3 frames
    (pilotless as there; ``pilots`` for the host receivers' piloted
    stream). Returns (Transmitter, noisy symbols complex64)."""
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size=frame_size,
                              pilots=pilots))
    rng = np.random.default_rng(3)
    pkts = _packets(rng, tx.df_bytes, F0 + 3)
    syms = tx.modulate_ts(pkts.reshape(-1))
    esn0 = 10 ** (esn0_db / 10)
    noisy = (
        syms + rng.normal(0, np.sqrt(1 / esn0 / 2), (syms.size, 2))
        @ np.array([1, 1j])
    ).astype(np.complex64)
    return tx, noisy


def sustained_stimulus(F=2, frame_size="normal", esn0_db=ESN0_DB,
                       rolloff=0.2, sps=2):
    """bench.py:191-215 (seed 7): T_WRAP steps of pilotless QPSK 1/2
    frames, cyclically pulse-shaped (tile x3, keep the middle period), plus
    noise of the sps-scaled per-sample sigma. Returns (Transmitter,
    packets, symbols, wave (period,) complex64)."""
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size=frame_size,
                              sps=sps, rolloff=rolloff))
    L = tx.cfg.pls_info.plframe_len
    per_frames = T_WRAP * F
    rng = np.random.default_rng(7)
    pkts = _packets(rng, tx.df_bytes, per_frames)
    syms = tx.modulate_ts(pkts.reshape(-1))[: per_frames * L]
    if syms.size != per_frames * L:
        raise RuntimeError("sustained stimulus under-filled")
    wave3 = tx.pulse_shape(np.tile(syms, 3))
    period = per_frames * L * sps
    mid = wave3[period: 2 * period]
    esn0 = 10 ** (esn0_db / 10)
    noise = rng.normal(0, np.sqrt(sps / esn0 / 2), (period, 2))
    wave = (mid + noise @ np.array([1, 1j])).astype(np.complex64)
    return tx, pkts, syms, wave


# ------------------------------------------------------------- sections


def measure_group_fec(C=64, F=2, esn0_db=ESN0_DB, device=None,
                      frame_size="normal"):
    """Stages 2 + 3: one ``BatchedPipeline.step`` over C x F frame-aligned
    lanes (PL sync, demap, one LDPC launch of B = C F, BCH, packing)."""
    dev = resolve_device(device)
    _peak_start(dev)
    cfg = RxConfig(modcod="qpsk1/2", frame_size=frame_size, fec_batch=C * F)
    tx, pkts, noisy = group_fec_stimulus(F, frame_size, esn0_db)
    pipe = BatchedPipeline(cfg, n_channels=C, frames_per_step=F, device=dev)
    h_np, p_np = pipe.frame_inputs_from_symbols(np.stack([noisy] * C))
    h = torch.as_tensor(h_np, device=dev)
    p = torch.as_tensor(p_np, device=dev)
    pipe.step(h, p, True)       # builds what the step makes lazily
    before = launch_counts()
    (kbytes, _, stats), syncs = count_syncs(lambda: pipe.step(h, p, True),
                                            dev)
    launches = _launches_since(before)
    kb = kbytes.cpu().numpy()
    ldpc_iters = int(stats["ldpc_iters"])
    bch_errors = int(stats["bch_errors"])
    ms = time_ms(lambda: pipe.step(h, p, True), _runs(dev), 2, 1, dev)
    ref = Transmitter(tx.cfg).bbframes(pkts.reshape(-1))[:F]
    # at the BCH output (scrambled BBFRAME bytes), over every lane
    ber = float(np.mean(np.unpackbits(kb ^ ref[None], axis=-1)))
    samples = C * F * pipe.frame_len * cfg.sps
    rec = {"channels": C, "frames_per_step": F, "esn0_db": esn0_db,
           "ldpc_iters": ldpc_iters, "post_fec_ber": ber,
           "bch_frame_errors": bch_errors,
           "group_fec_samples_per_step": samples,
           "group_fec_host_syncs_per_step": syncs,
           "group_fec_launches_per_step": launches,
           # the step's inputs, its int8 LLRs (N, B) and its output bytes;
           # the LDPC messages stay in the kernel's shared memory
           "group_fec_device_bytes": {
               "inputs": _nbytes(h, p),
               "llrs": cfg.fec.nldpc * C * F, "kbytes": _nbytes(kbytes)},
           "group_fec_peak_device_mib": _peak_mib(dev)}
    _spread(rec, "t_group_fec_s", ms, 1e-3)
    _rate_spread(rec, "group_fec_msps", samples, ms)
    rec["group_fec_ok"] = bch_errors == 0 and ber == 0.0
    if not rec["group_fec_ok"]:
        rec["group_fec_error"] = (f"integrity FAILED: bch_frame_errors "
                                  f"{bch_errors}, post_fec_ber {ber}")
    return rec


def _frontend_check(sync, cpu, state, samples, n_out, out):
    """One ``sync.step_batched``'s outputs ``out`` = (state', symbols,
    consumed) from ``state`` on ``samples``, against references on the same
    state and block: the symbols against the plain matched filter on the
    step's own tracker output, within MF_TOL of their RMS; the tracker
    against its run by ``cpu``, the same FeedForwardSync on the CPU:
    consumed exact, tau and the drift over the block within TRACK_TOL
    samples. Returns (ok, the errors found)."""
    new, syms, consumed = out
    _, taps, off, _ = sync._track(state, samples, n_out)
    want = mf_segmented_plain(samples, taps, off, sync.sps,
                              n_out // taps.shape[1], sync._off)
    rms = float(want.square().mean().sqrt())
    mf_err = float((syms - want).abs().max())
    ref, _, _, ref_consumed = cpu._track(
        FFSyncState(*(x.cpu() for x in (state.tau, state.rate,
                                        state.initialized))),
        samples.cpu(), n_out)
    tau_err = float((new.tau.cpu() - ref.tau).abs().max())
    drift_err = float((new.rate.cpu() - ref.rate).abs().max()) * n_out
    consumed_ok = torch.equal(consumed.cpu(), ref_consumed)
    found = {"mf_max_abs_err": mf_err, "mf_rms": rms,
             "tau_max_abs_err": tau_err, "drift_max_abs_err": drift_err,
             "consumed_equal": consumed_ok}
    ok = (mf_err <= MF_TOL * rms and consumed_ok and tau_err <= TRACK_TOL
          and drift_err <= TRACK_TOL)
    return ok, found


def measure_frontend(C=64, n_out=FE_N_OUT, esn0_db=ESN0_DB, device=None,
                     frame_size="normal"):
    """Stage 1: ``FeedForwardSync.step_batched`` (O&M timing, tracking, one
    matched-filter launch of C x 16 segments) over the group + FEC
    section's noisy symbols, chained by threading the timing state."""
    dev = resolve_device(device)
    _peak_start(dev)
    cfg = RxConfig(modcod="qpsk1/2", frame_size=frame_size)
    _, _, noisy = group_fec_stimulus(2, frame_size, esn0_db)
    sync = FeedForwardSync(sps=cfg.sps, rolloff=cfg.rolloff, device=dev)
    n_samp = n_out * cfg.sps + sync.history() + 64
    stim = np.resize(noisy, n_samp).astype(np.complex64)
    samples = torch.as_tensor(cplx.from_np(np.stack([stim] * C)), device=dev)
    box = [sync.init_state(C)]

    def step():
        box[0], syms, consumed = sync.step_batched(box[0], samples, n_out)
        return syms, consumed

    step()                      # builds what the step makes lazily
    before = launch_counts()
    (syms, consumed), syncs = count_syncs(step, dev)
    launches = _launches_since(before)
    ms = time_ms(step, _runs(dev), 2, 10 if dev.type == "cuda" else 1, dev)
    state = box[0]
    syms, consumed = step()
    checked, found = _frontend_check(
        sync, FeedForwardSync(sps=cfg.sps, rolloff=cfg.rolloff, device="cpu"),
        state, samples, n_out, (box[0], syms, consumed))
    finite = bool(torch.isfinite(syms).all())
    # the tracker keeps each block's start within the extraction window
    drift = consumed.cpu().numpy() - n_out * cfg.sps
    samples_per_step = C * n_out * cfg.sps
    rec = {"frontend_block_syms": n_out,
           "frontend_segments": sync.segments(n_out),
           "frontend_host_syncs_per_step": syncs,
           "frontend_launches_per_step": launches,
           "frontend_device_bytes": {"samples": _nbytes(samples),
                                     "symbols": _nbytes(syms)},
           "frontend_peak_device_mib": _peak_mib(dev),
           "frontend_check": found}
    _spread(rec, "t_frontend_s", ms, 1e-3)
    _rate_spread(rec, "frontend_msps", samples_per_step, ms)
    rec["frontend_ok"] = (checked and finite
                          and tuple(syms.shape) == (C, n_out, 2)
                          and bool((np.abs(drift) <= sync._off).all()))
    if not rec["frontend_ok"]:
        rec["frontend_error"] = (f"integrity FAILED: {found}, finite "
                                 f"{finite}, shape {tuple(syms.shape)}, "
                                 f"consumed - n_out sps "
                                 f"{sorted(set(drift.tolist()))}")
    return rec


def measure_vcm(C=64, F=2, W=40, esn0_db=13.0, device=None,
                frame_size="normal"):
    """Sustained rate of ``VCMStreamReceiver.step`` on a 2-PLS stream
    (piloted QPSK 1/2 + 8PSK 3/5, PLS 17 and 49 at normal frames): a
    periodic stimulus staged on the device once and sliced with
    wraparound, W steps chained through the state, every step's stats
    and outputs kept on the device and read after the timing (a step
    reads only its queue fill), then the audit (BCH errors, lock, walked
    frames against the frames the stimulus carries, rejected frames)."""
    dev = resolve_device(device)
    _peak_start(dev)
    short = frame_size == "short"
    pls_a, pls_b = make_pls(4, short, True), make_pls(12, short, True)
    cfg = RxConfig(modcod="qpsk1/2", frame_size=frame_size, acm_vcm=True,
                   pls_expected=(pls_a, pls_b))
    sr = VCMStreamReceiver(cfg, n_channels=C, frames_per_step=F, device=dev)
    n_in = sr.n_in
    _, wave, pair_syms = vcm_stimulus(sr._n_fe, frame_size, esn0_db, cfg.sps)
    period = wave.size
    prefix = np.resize(wave, sr._n_fe + 8)[: sr._n_fe]
    state = sr.prime(np.stack([prefix] * C))
    if not sr.prime_ok.all():
        raise RuntimeError("VCM bench prime failed")
    off0 = sr._n_fe % period
    src2 = torch.as_tensor(cplx.from_np(np.concatenate([wave, wave[:n_in]])),
                           device=dev)

    def blk(i):
        off = (off0 + i * n_in) % period
        return src2[off: off + n_in][None].expand(C, n_in, 2)

    state, outputs, stats = sr.step(state, blk(0))
    (state, outputs, stats), syncs = count_syncs(
        lambda: sr.step(state, blk(1)), dev)
    frames_warm = int(stats["frames"])
    errs_warm = sum(int((nc[fired] < 0).sum()) for nc, fired in zip(
        (x.cpu().numpy() for x in outputs["n_corr"]), outputs["fired"]))

    before = launch_counts()
    all_stats, all_out, ticks = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(W):
        state, outputs, stats = sr.step(state, blk(2 + i))
        all_stats.append(stats)
        all_out.append(outputs)
        ticks.append(time.perf_counter())
    _sync(dev)
    ticks[-1] = time.perf_counter()     # the last interval waits for the card
    t_dev = ticks[-1] - t0
    launches = _launches_since(before)

    frames = sum(int(st["frames"]) for st in all_stats)
    dummies = sum(int(st["dummies"]) for st in all_stats)
    rejected = sum(int(st["rejected"]) for st in all_stats)
    locked_end = bool(all_stats[-1]["locked"].all())
    errs = decoded = 0
    for out in all_out:
        for nc, fired in zip(out["n_corr"], out["fired"]):
            nc = nc.cpu().numpy()[fired]
            decoded += nc.size
            errs += int((nc < 0).sum())
    expected_frames = W * C * sr.n_out / (pair_syms / 2)
    ratio = frames / expected_frames
    ok = (errs == 0 and locked_end and rejected == 0
          and 0.9 <= ratio <= 1.05)
    steps_ms = np.diff([t0] + ticks) * 1e3
    samples = C * n_in
    rec = {
        "vcm_sustained_msps": W * samples / t_dev / 1e6,
        "vcm_step_ms": t_dev / W * 1e3,
        "vcm_step_ms_min": float(steps_ms.min()),
        "vcm_step_ms_max": float(steps_ms.max()),
        "vcm_steps": W, "vcm_channels": C, "vcm_frames": frames,
        "vcm_frames_ratio": ratio, "vcm_frames_decoded": decoded,
        "vcm_dummies": dummies, "vcm_rejected": rejected,
        "vcm_bch_errors": errs, "vcm_warm_bch_errors": errs_warm,
        "vcm_warm_frames": frames_warm, "vcm_locked_end": locked_end,
        "vcm_host_syncs_per_step": syncs,
        "vcm_launches": launches,
        # the carried state (sample buffer, symbol ring, per-PLS LLR
        # queues), the staged stimulus, and the W steps' kept outputs
        "vcm_device_bytes": {"state": _nbytes(state),
                             "staged_iq": _nbytes(src2),
                             "outputs_kept": _nbytes(all_out)},
        "vcm_peak_device_mib": _peak_mib(dev),
        "vcm_ok": bool(ok),
        "vcm_note": (
            "VCMStreamReceiver.step (rx/vcm_stream.py), 2-PLS qpsk1/2 + "
            "8psk3/5 piloted alternating, device-staged periodic IQ, steps "
            "chained through the state, host clock over the W steps (each "
            "step reads its queue fill back: see vcm_host_syncs_per_step); "
            "vcm_step_ms_min/_max are single steps' host intervals"),
    }
    rec["vcm_sustained_msps_min"] = samples / rec["vcm_step_ms_max"] / 1e3
    rec["vcm_sustained_msps_max"] = samples / rec["vcm_step_ms_min"] / 1e3
    if not ok:
        rec["vcm_error"] = (f"VCM integrity FAILED: errors={errs} "
                            f"locked_end={locked_end} rejected={rejected} "
                            f"frames_ratio={ratio:.3f}")
    return rec


def acm_stages(rx, noisy, pls, F0=ACM_F0, CB=ACM_CB, runs=20, warmup=1):
    """bench.py measure_acm's stages on one group-sized window of
    ``noisy`` (frame-aligned symbols of one PLS) through ``rx``'s batched
    device calls, at one channel and at CB: the dense timing metric
    (``_metric_batch``), the window PLSC decode (``_win_plsc_batch``), the
    per-PLS group program (``_acm_group_batch``) and its FEC
    (``_fec_batch``, the channels' frames pooled into one decode), plus
    the 128-lane pooled FEC (CB channels x 4 windows). Returns (times by
    stage: (median, min, max) ms of one call, its host readback included;
    the single stream's n_corr (F0,))."""
    dev = rx.device
    W = rx._win_len
    win = np.resize(noisy, W)
    d = rx._put(win)
    K = W // 3330 + 3
    sofs = (np.arange(K) % max(W - 90, 1)).astype(np.int32)
    info = parse_pls(pls)
    L, Lp = info.plframe_len, info.payload_len
    hidx = np.arange(F0 + 1)[:, None] * L + np.arange(90)[None, :]
    pidx = 90 + np.arange(F0)[:, None] * L + np.arange(Lp)[None, :]
    g_req = (pls, cplx.from_np(win[hidx]), pls, cplx.from_np(win[pidx]),
             True, 0.0)
    rows = rx._acm_group_batch([g_req])[0]["llrs"]            # (F0, N)
    rows128 = torch.cat([rows] * (128 // (CB * F0)))

    def t(fn):
        return time_ms(fn, runs, warmup, 1, dev)

    times = {}
    for C, suf in ((1, ""), (CB, "8")):
        times["metric" + suf] = t(lambda: rx._metric_batch([(d,)] * C))
        times["plsc" + suf] = t(
            lambda: rx._win_plsc_batch([(d, sofs, 0.0, False)] * C))
        times["group" + suf] = t(lambda: rx._acm_group_batch([g_req] * C))
        times["fec" + suf] = t(lambda: rx._fec_batch([(pls, rows, True)] * C))
    times["fec128_pooled"] = t(
        lambda: rx._fec_batch([(pls, rows128, True)] * CB))
    n_corr = rx._fec_batch([(pls, rows, True)])[0][3]
    return times, n_corr


def measure_acm(esn0_db=ESN0_DB, device=None, frame_size="normal"):
    """ACM steady state: the windowed ``ACMReceiver``'s stage calls on one
    group-sized window of a pilotless QPSK 1/2 stream (``acm_stages``), one
    stream and 8 channels. ``acm_msps_per_stream`` is per stream (compare
    with the CCM figure per channel, ``value`` / 64)."""
    dev = resolve_device(device)
    _peak_start(dev)
    cfg = RxConfig(modcod="qpsk1/2", frame_size=frame_size, acm_vcm=True,
                   fec_batch=ACM_F0, frame_group=ACM_F0)
    rx = ACMReceiver(cfg, device=dev)
    _, noisy = acm_stimulus(ACM_F0, frame_size, esn0_db)
    before = launch_counts()
    times, n_corr = acm_stages(rx, noisy, cfg.pls, runs=_runs(dev))
    launches = _launches_since(before)
    stages = ("metric", "plsc", "group", "fec")
    samples = ACM_F0 * cfg.pls_info.plframe_len * cfg.sps
    t1 = sum(times[s][0] for s in stages) / 1e3
    t8 = sum(times[s + "8"][0] for s in stages) / 1e3
    rec = {"acm_window_syms": rx._win_len,
           "acm_bch_errors": int((np.asarray(n_corr) < 0).sum()),
           "acm_launches": launches,
           # one window of planar float32 symbols a channel, and the
           # 128-lane pool's int8 LLRs
           "acm_device_bytes": {"window": rx._win_len * 8,
                                "window_c8": ACM_CB * rx._win_len * 8,
                                "llrs_pooled_128": 128 * cfg.fec.nldpc},
           "acm_peak_device_mib": _peak_mib(dev)}
    for s in stages:
        _spread(rec, f"acm_t_{s}_s", times[s], 1e-3)
        _spread(rec, f"acm_t_{s}8" + ("_pooled_s" if s == "fec" else "_s"),
                times[s + "8"], 1e-3)
    _spread(rec, "acm_t_fec128_pooled_s", times["fec128_pooled"], 1e-3)
    rec.update(
        acm_msps_per_stream=samples / t1 / 1e6,
        acm_msps_c8=ACM_CB * samples / t8 / 1e6,
        acm_t_c8_s=t8,
        acm_note=(
            "ACMReceiver's batched stage calls on one group-sized window "
            f"({ACM_F0} pilotless QPSK 1/2 frames): dense metric, window "
            "PLSC decode, group program, FEC (LDPC B = 4), each timed as one "
            "call with its host readback; acm_msps_c8 = the same stages at "
            f"{ACM_CB} channels with the frames pooled into one decode "
            f"(B = {ACM_CB * ACM_F0}); acm_t_fec128_pooled_s is the 128-lane "
            "pooled decode (4 windows of 8 channels)"))
    rec["acm_c8_vs_serial"] = rec["acm_msps_c8"] / rec["acm_msps_per_stream"]
    rec["acm_ok"] = rec["acm_bch_errors"] == 0
    if not rec["acm_ok"]:
        rec["acm_error"] = (f"ACM integrity FAILED: acm_bch_errors "
                            f"{rec['acm_bch_errors']}")
    return rec


def measure_sustained(C=64, F=2, W=40, LAG=4, esn0_db=ESN0_DB, device=None,
                      frame_size="normal"):
    """Sustained IQ -> TS rate of the device-resident ``StreamReceiver``
    step over a periodic stimulus staged on the device once, three
    policies (host clock over W steps each):

    - A, ``sustained_msps``: chained steps; each step's BBFRAMEs and CRC
      flags are copied out (non-blocking, into pinned host memory) and
      stitched to TS by a reader thread up to 2 LAG steps behind;
    - B, ``sustained_device_msps``: chained steps, one readback at the end
      (the eager step still reads its BCH all-clean flag: see
      ``sustained_host_syncs_per_step``);
    - C, ``sustained_scan_msps``: ``make_scan_step(8)``, one CUDA-graph
      replay of 8 chained steps a call.

    Integrity: per-step BCH errors, lock, and delivered TS bytes within
    0.95-1.05 of the payload the steps decode."""
    dev = resolve_device(device)
    _peak_start(dev)
    cfg = RxConfig(modcod="qpsk1/2", frame_size=frame_size,
                   sym_sync_impl="ffw", fec_batch=C * F)
    sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F, device=dev)
    n_in = sr.n_in
    tx, pkts, _, wave = sustained_stimulus(F, frame_size, esn0_db,
                                           cfg.rolloff, cfg.sps)
    period = wave.size
    prefix = np.resize(wave, sr._n_fe + 8)[: sr._n_fe]
    state = sr.prime(np.stack([prefix] * C))
    off0 = sr._n_fe % period
    rolled = np.resize(np.roll(wave, -off0), (T_WRAP * n_in,))
    src_np = cplx.from_np(rolled.reshape(T_WRAP, n_in)).astype(np.float32)
    src = torch.as_tensor(src_np, device=dev)            # (T_WRAP, n_in, 2)

    def step_i(state, i):
        return sr.step(state, src[i % T_WRAP][None].expand(C, n_in, 2))

    state, kb, stats = step_i(state, 0)
    (state, kb, stats), syncs = count_syncs(lambda: step_i(state, 1), dev)
    errs0 = int(stats["bch_errors"])

    scr = bb_derandomizer_bytes(cfg.fec.kbch // 8)
    kb0, ok0, hdr0 = (x.cpu().numpy() for x in (kb, stats["ts_ok"],
                                                stats["hdr_ok"]))

    def stitch(stitcher, kb_np, ok_np, hdr_np, parts=None):
        ts = stitcher.push_step(kb_np ^ scr[None, None], ok_np, hdr_np)
        for c, t in enumerate(ts if parts is not None else ()):
            parts[c].append(t)
        return sum(t.size for t in ts)

    def stitch_host_crc(stitcher, kb_np):
        frames = kb_np ^ scr[None, None]
        ok, hdr = packet_validity(torch.from_numpy(frames.reshape(C * F, -1)))
        return stitch(stitcher, kb_np, ok.numpy().reshape(C, F, -1),
                      hdr.numpy().reshape(C, F))

    # host stitch cost of one step: device CRC flags, or the CRC on the host
    probe = BatchTSStitcher(C)
    t_stitch_flag = time_ms(lambda: stitch(probe, kb0, ok0, hdr0), 3, 1, 1,
                            "cpu")
    t_stitch_host = time_ms(lambda: stitch_host_crc(probe, kb0), 3, 0, 1,
                            "cpu")
    stitcher = BatchTSStitcher(C)

    # ---- policy A: chained steps, copies out, reader thread stitches
    fetchq = queue.Queue(maxsize=2 * LAG)
    ts_acc = [0]
    ts_parts = [[] for _ in range(C)]       # each channel's TS, by step
    reader_err = []

    def reader():
        while True:
            item = fetchq.get()
            try:
                if item is None:
                    return
                done, kb_h, ok_h, hdr_h = item
                if done is not None:
                    done.synchronize()
                ts_acc[0] += stitch(stitcher, kb_h.numpy(), ok_h.numpy(),
                                    hdr_h.numpy(), ts_parts)
            except Exception as e:       # raised on the feeding thread
                reader_err.append(e)
            finally:
                fetchq.task_done()

    def copy_out(*ts):
        if dev.type != "cuda":
            return (None,) + tuple(t.clone() for t in ts)
        out = []
        for t in ts:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        done = torch.cuda.Event()
        done.record()
        return (done,) + tuple(out)

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    all_stats, ticks_a = [], []
    before = launch_counts()
    _sync(dev)
    t0_a = time.perf_counter()
    try:
        for i in range(W):
            state, kb, stats = step_i(state, 2 + i)
            fetchq.put(copy_out(kb, stats["ts_ok"], stats["hdr_ok"]))
            all_stats.append(stats)
            ticks_a.append(time.perf_counter())
        fetchq.join()                        # every TS byte delivered
        ticks_a[-1] = time.perf_counter()
        t_a = ticks_a[-1] - t0_a
    finally:
        fetchq.put(None)
        rt.join(timeout=60)
    if reader_err:
        raise reader_err[0]
    launches_a = _launches_since(before)
    ts_bytes = ts_acc[0]

    # ---- policy B: outputs stay on the device, one readback at the end
    ticks_b = []
    _sync(dev)
    t0_b = time.perf_counter()
    for i in range(W):
        state, kb, stats = step_i(state, 2 + W + i)
        all_stats.append(stats)
        ticks_b.append(time.perf_counter())
    int(stats["bch_errors"])
    ticks_b[-1] = time.perf_counter()
    t_b = ticks_b[-1] - t0_b

    # ---- policy C: T_SCAN chained steps per call (one graph replay)
    scan = sr.make_scan_step(T_SCAN)
    idx = torch.arange(T_SCAN, device=dev) % T_WRAP
    blocks = src[idx][:, None].expand(T_SCAN, C, n_in, 2)
    state, _, sstats = scan(state, blocks)              # capture + warm
    _sync(dev)
    n_calls = max(1, W // T_SCAN)
    scan_stats, ticks_c = [], []
    (state, _, sstats), scan_syncs = count_syncs(
        lambda: scan(state, blocks), dev)
    _sync(dev)
    t0_c = time.perf_counter()
    for _ in range(n_calls):
        state, _, sstats = scan(state, blocks)
        # the graph's outputs are overwritten by the next call
        scan_stats.append({"bch_errors": sstats["bch_errors"].clone(),
                           "locked": sstats["locked"][-1].clone()})
        _sync(dev)      # a call does not wait for the card: its interval
        ticks_c.append(time.perf_counter())
    t_c = ticks_c[-1] - t0_c
    errs_c = sum(int(s["bch_errors"].sum()) for s in scan_stats)
    locked_c = bool(scan_stats[-1]["locked"].all())

    # ---- integrity: per-step errors, lock state, delivered TS bytes
    err_steps = [int(st["bch_errors"]) for st in all_stats]
    total_errs = errs0 + sum(err_steps)
    locked_end = bool(all_stats[-1]["locked"].all())
    expected_ts = W * C * F * tx.df_bytes
    ts_ratio = ts_bytes / max(expected_ts, 1)
    ts_lost = expected_ts - ts_bytes
    # A stimulus period (T_WRAP steps, T_WRAP F frames) carries q whole
    # packets and the head of one more, which never completes: the period
    # after the wrap starts with a new packet. So each channel's TS must be
    # a consecutive run of the period's q packets, repeated, and W steps
    # deliver W q / T_WRAP of them, less the one the first frame may cut
    # (the last frame's unfinished one is the same packet of the period),
    # and up to half a tail either way when W is not a multiple of T_WRAP.
    # At normal frames (85 of 85.45 packets a period) this holds the ratio
    # within bench.py's 0.95-1.05 from W = 2 on (0.990 at W = 8).
    q = T_WRAP * F * tx.df_bytes // 188
    want_pkts = W * q / T_WRAP
    runs = [_cyclic_run(np.concatenate(p) if p else np.zeros(0, np.uint8),
                        pkts[:q]) for p in ts_parts]
    runs_ok = all(n >= 0 and abs(want_pkts - n) <= 1.5 for n in runs)
    ok = (total_errs == 0 and errs_c == 0 and locked_end and locked_c
          and runs_ok)

    # ---- host -> device: one channel's block from pageable memory
    blk_np = np.ascontiguousarray(src_np[0])
    h2d = time_ms(lambda: (torch.as_tensor(blk_np).to(dev), _sync(dev)),
                  _runs(dev), 2, 1, "cpu")

    samples = C * n_in
    rec = {
        "sustained_msps": W * samples / t_a / 1e6,
        "sustained_device_msps": W * samples / t_b / 1e6,
        "sustained_scan_msps": n_calls * T_SCAN * samples / t_c / 1e6,
        "stitch_ms_flagged": t_stitch_flag[0],
        "stitch_ms_host_crc": t_stitch_host[0],
        "stitch_native": stitcher._ext is not None,
        "sustained_scan_bch_errors": errs_c,
        "sustained_scan_locked": locked_c,
        "sustained_steps": W,
        "sustained_scan_calls": n_calls,
        "sustained_ts_bytes": int(ts_bytes),
        "sustained_bch_errors": total_errs,
        "sustained_ok": bool(ok),
        "sustained_bch_error_steps": int(np.count_nonzero(err_steps)),
        "sustained_locked_end": locked_end,
        "sustained_ts_expected": int(expected_ts),
        "sustained_ts_ratio": ts_ratio,
        "sustained_ts_lost": int(ts_lost),
        "sustained_ts_packets_expected": want_pkts,
        "sustained_ts_packets_by_channel": [min(runs), max(runs)],
        "sustained_ts_runs_ok": runs_ok,
        "sustained_host_syncs_per_step": syncs,
        "sustained_scan_host_syncs_per_call": scan_syncs,
        "sustained_launches_policy_a": launches_a,
        # the carried state, the staged stimulus and the scan graph's
        # static block buffer (T_SCAN steps of every channel's IQ)
        "sustained_device_bytes": {
            "state": _nbytes(state), "staged_iq": _nbytes(src),
            "scan_blocks": T_SCAN * C * n_in * 2 * 4},
        "sustained_peak_device_mib": _peak_mib(dev),
        "sustained_scan_launches_per_call": scan.launches_per_call,
        "h2d_msps_per_channel": n_in / h2d[0] / 1e3,
        "h2d_msps_per_channel_min": n_in / h2d[2] / 1e3,
        "h2d_msps_per_channel_max": n_in / h2d[1] / 1e3,
        "sustained_note": (
            "StreamReceiver.step over a device-staged periodic IQ source; "
            "host clock over W steps a policy; A copies each step's "
            "BBFRAMEs and CRC flags out (pinned, non-blocking) and a reader "
            "thread stitches them (BatchTSStitcher; stitch_native says "
            "whether the native stitch ran); B keeps outputs on the device; "
            "C replays one CUDA graph of 8 steps a call. "
            "h2d_msps_per_channel: one channel's block (n_in samples) from "
            "pageable host memory to the device, as the engines feed it, "
            "host clock with a synchronise. stitch_ms_host_crc: the CRC-8 "
            "validity map by its plain version on the host, then the same "
            "stitch. *_min/_max: single steps' (or scan calls') host "
            "intervals (each eager step waits for its BCH flag; each scan "
            "call is waited for)"),
    }
    for key, gaps, k in (
            ("sustained_msps", np.diff([t0_a] + ticks_a), 1),
            ("sustained_device_msps", np.diff([t0_b] + ticks_b), 1),
            ("sustained_scan_msps", np.diff([t0_c] + ticks_c), T_SCAN)):
        rec[key + "_min"] = float(k * samples / gaps.max() / 1e6)
        rec[key + "_max"] = float(k * samples / gaps.min() / 1e6)
    if not ok:
        rec["sustained_error"] = (
            f"stream integrity FAILED: errors={total_errs} "
            f"scan_errors={errs_c} locked_end={locked_end} "
            f"scan_locked={locked_c} ts_ratio={ts_ratio:.4f} "
            f"ts_lost={ts_lost} packets by channel {sorted(set(runs))} "
            f"(-1: not a consecutive run), expected {want_pkts}")
    return rec


# ----------------------------------------------------------------- main


def smi():
    """``nvidia-smi``'s name and power limit of the first card; raises
    when it cannot be read."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def _card(dev):
    """The record's ``card``: ``smi()``, or why it could not be read."""
    if dev.type != "cuda":
        return None
    try:
        return smi()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def headline(detail):
    """The record around ``detail``: ``iq_to_ts_throughput``, the front end
    and group + FEC stages back to back on one card (seconds per sample
    add up), against the reference's CPU operating point; None where a
    stage has no figure."""
    result = {"metric": "iq_to_ts_throughput", "value": None,
              "unit": "Msamples/s/chip", "vs_baseline": None,
              "detail": detail}
    if "frontend_msps" in detail and "group_fec_msps" in detail:
        msps = 1.0 / (1.0 / detail["frontend_msps"]
                      + 1.0 / detail["group_fec_msps"])
        result["value"] = msps
        result["vs_baseline"] = msps / REF_MSPS
    return result


def compact(result, full_record=None):
    """The compact JSON line of a record (under 2,000 characters): the
    headline, the headline keys, every section's ``_ok`` flag and every
    ``_error``/``_skipped`` note."""
    detail = result.get("detail", {})
    head = {k: result[k] for k in ("metric", "value", "unit", "vs_baseline")
            if k in result}
    head["device"] = detail.get("device")
    for k in HEADLINE_KEYS + tuple(f"{s}_ok" for s in SECTIONS):
        if k in detail:
            head[k] = detail[k]
    for k, v in detail.items():
        if k.endswith("_error") or k.endswith("_skipped"):
            head[k] = str(v)[:120]
    if full_record is not None:
        head["full_record"] = full_record
    line = json.dumps(head)
    if len(line) > 1950:        # hard cap: drop notes, keep numbers
        head = {k: v for k, v in head.items()
                if not isinstance(v, str) or len(v) < 40}
        line = json.dumps(head)[:1950]
    return line


def emit(result, path=None):
    """Write the full record to ``path`` (``FULL_RECORD_PATH``), then
    print and flush its compact line."""
    path = Path(path or FULL_RECORD_PATH)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    root = FULL_RECORD_PATH.parent.parent
    shown = (str(path.relative_to(root)) if path.is_relative_to(root)
             else str(path))
    print(compact(result, shown), flush=True)


def _run_section(detail, name, fn):
    """fn()'s record into ``detail``; an exception becomes
    ``<name>_error`` and ``<name>_ok`` false (the next section runs)."""
    try:
        detail.update(fn())
    except Exception as e:      # a failed section must not lose the rest
        detail[f"{name}_error"] = f"{type(e).__name__}: {e}"
        detail[f"{name}_ok"] = False


def main(argv=None):
    """Run every section, emit after each, return the exit code: 0 when
    every section ran and passed its integrity check."""
    ap = argparse.ArgumentParser(
        prog="python -m dvbs2rx_tpu_torch.bench",
        description="Steady-state IQ -> TS throughput of the port.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--frame-size", default="normal",
                    choices=("normal", "short"))
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40,
                    help="W: timed steps of the VCM and sustained sections")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    budget = float(os.environ.get("BENCH_BUDGET_S", "1800"))
    dev = resolve_device(args.device)
    C, F, fs = args.channels, 2, args.frame_size
    detail = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": _card(dev),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "frame_size": fs,
        "timing": ("CUDA events: median (and _min/_max) of timings of "
                   "back-to-back calls after warm-up; sustained and VCM: "
                   "host clock over W chained steps" if dev.type == "cuda"
                   else "host clock (a CPU rehearsal: no time here is a "
                        "device figure)"),
    }
    _run_section(detail, "group_fec",
                 lambda: measure_group_fec(C, F, device=dev, frame_size=fs))
    _run_section(detail, "frontend",
                 lambda: measure_frontend(C, device=dev, frame_size=fs))
    result = headline(detail)
    detail["elapsed_s"] = time.monotonic() - t_start
    emit(result)
    gc.collect()

    for name, fn in (
            ("vcm", lambda: measure_vcm(C, F, args.steps, device=dev,
                                        frame_size=fs)),
            ("acm", lambda: measure_acm(device=dev, frame_size=fs)),
            ("sustained", lambda: measure_sustained(
                C, F, args.steps, device=dev, frame_size=fs))):
        left = budget - (time.monotonic() - t_start)
        if left < SECTION_MIN_BUDGET[name]:
            detail[f"{name}_skipped"] = (
                f"wall-clock budget exhausted ({left:.0f} s left < "
                f"{SECTION_MIN_BUDGET[name]} s section minimum)")
            detail[f"{name}_ok"] = False
        else:
            _run_section(detail, name, fn)
        detail["elapsed_s"] = time.monotonic() - t_start
        emit(result)
        gc.collect()
    return 0 if all(detail.get(f"{s}_ok") for s in SECTIONS) else 1


if __name__ == "__main__":
    sys.exit(main())
