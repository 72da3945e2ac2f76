#!/usr/bin/env python3
"""Time the CUDA kernels of several checkouts of this repository, in turns.

    python3 tools/torch_kernel_ab.py ROOT [ROOT ...] [--rounds 1]
    python3 tools/torch_kernel_ab.py ROOT [ROOT ...] --frontend

Each round runs the checkouts in the order given and then in reverse, every
run in a process of its own that builds that checkout's kernels and times
them on ``chip_smoke.py``'s inputs with its timer (``_time_ms``: median of
20 CUDA-event timings, each of 10 back-to-back calls, after 2 warm-ups):

* ``ldpc_ms``: LDPC case (a) -- S2_B4, B = 128, encoded codewords as +-14
  LLRs with 2% sign flips (numpy seed 5), 25 trials -- through
  ``CudaLDPCDecoder.decode_lane_major`` on a contiguous (N, B) input;
* ``ldpc_iter_us``: one LDPC iteration, from random S2_B4 LLRs at B = 128
  (no frame converges): the time at max_trials 4 less that at 0, over 4;
* ``mf_ms``: ``fir_cuda.mf_segmented`` at the headline shape of phase 3;
* ``gardner_ms``: ``SymbolSync.step`` (the Gardner kernel) on one
  4,096-symbol front-end block of phase 8's waveform, polyphase at sps 2
  and 4 (``gardner_sps4_ms``), one channel; null for a checkout without
  the Gardner kernel;
* ``bch_ms``: ``BCHDecoder.decode_lane_major(sync_free=True)`` on phase
  11's S2_B4, B = 128 error batch (``_fec_tail_codewords`` with phase 11's
  seed): the whole card decode, whatever kernels the checkout has (the
  syndrome matmul and two kernels before the locator, the locator and
  Chien after); ``bch_clean_ms`` the default form on a clean batch (the
  syndromes and the all-clean readback); null for a checkout without the
  BCH kernels;
* ``crc8_ms``: ``crc8_cuda.crc8_validity`` on phase 11's S2_B4 Tx
  BBFRAMEs (``_crc_inputs`` with seed 2032, B = 128, n = 4,026, window
  187), and ``crc8_device_ms`` its ``torch.profiler`` device time (mean
  over 20 launches: an event timing of one small launch is the host's
  enqueue rate); null for a checkout without the CRC-8 kernel;
* ``plsync_payload_ms`` and ``plsync_header_ms``: ``plsync_cuda.payload``
  and ``plheader`` at the CCM step's shape (64 channels x 2 frames of
  QPSK 1/2 normal pilotless, B = 128 lane-major LLRs, the payloads read in
  place from one symbol buffer, frame 0's symbols out; both header sets
  with metric and autocorrelation) and ``plsync_*_vcm_*_ms`` at the VCM
  step's (256 lanes of a 64-channel ring, piloted PLS 17 and 49, 64 lanes
  each selected, (B, n_ldpc) rows; 1,344 x 2 headers with the
  autocorrelation, the VCM step's layout until the walk kernel kept the
  books, and ``plsync_header_vcm_lanes``: its layout since, the 256
  lanes' own and next headers without it), on seeded noisy QPSK / 8PSK
  symbols: the profiler's device time of the call's kernels (a payload
  call's one or two launches summed), and ``*_events_ms`` the CUDA-event
  time; null for a checkout without the PL sync kernels;
* ``walk_ms`` and ``walk_dummy_ms``: the VCM walk kernel on phase 6's
  state (``chip_smoke._walk_states``: 64 channels of piloted QPSK 1/2 and
  8PSK 3/5 normal frames after 16 steps, the default PLSC mode) and on its
  ring of dummy frames (every one of the 21 slots alive): the profiler's
  device time, and ``*_events_ms`` the CUDA-event time; a checkout whose
  kernel keeps the books (``VCMStreamReceiver._walk_books``) is timed
  through that, an older one through ``_walk``; null for a checkout
  without the walk kernel.

With ``--frontend`` each run times the shared front end instead, and
nothing else:

* ``fe_ccm_*`` and ``fe_vcm_*``: ``StreamFrontEnd._frontend`` (AGC,
  rotator, buffer append, O&M tracker and matched filter) of a 64-channel
  ``StreamReceiver`` (QPSK 1/2 normal, 2 frames a step) and
  ``VCMStreamReceiver`` (piloted PLS 17 + 49) on a seeded state (sample
  buffer full to a steady step's fill, tracker initialised, a rotator
  increment of 1e-3 rad a sample) and a seeded noise block: the profiler's
  device time of all the call's kernels (``_device_ms``), its kernel
  launches, and the CUDA-event time (``_events_ms``);
* ``fe_bench_*``: the bench's front-end call, ``FeedForwardSync.
  step_batched`` at C = 64 and 32,768 symbols on its stimulus, the same
  three figures, and ``frontend_msps``, the bench section's own record
  (``bench.measure_frontend``);
* ``track_*_ms``: the O&M tracker kernel alone, the profiler's device
  time: ``ccm``, ``vcm`` and ``bench`` on the arguments of the tracker
  launch inside the calls above (its first), ``host_c1`` / ``host_c8``
  on a host receiver's 4,096-symbol block (one window of 8,295 samples)
  at 1 and 8 channels, ``host16k_c1`` / ``host16k_c8`` on one window of
  16,383 samples (8,140 symbols), both from the bench's noisy stimulus
  with the tracker state initialised.

It prints one JSON line per run, with a digest of the LDPC case's four
outputs (with ``--frontend``: of the front end's outputs, and
``track_digest``, of the tracker's alone at the seven shapes: tau, rate,
initialized, taps, offsets, consumed), and a last line with each
checkout's times and whether every digest agrees. The timer and the inputs come from this checkout's
``chip_smoke.py``; the kernels from each ROOT. Needs one CUDA card.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(root: str, frontend: bool = False):
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve()))
    if frontend:
        return print(json.dumps({"root": root, **_frontend_times()}))
    from dvbs2rx_tpu_torch.ops import fir_cuda, ldpc_cuda

    # the checkout's own code tables, wherever that checkout imports them
    get_code = sys.modules[ldpc_cuda.LDPCCode.__module__].get_code
    code = get_code("S2_B4")
    llrs = chip_smoke._ldpc_inputs(code, np.random.default_rng(5), 128,
                                   "converging")
    xT = torch.from_numpy(np.ascontiguousarray(llrs.T)).cuda()
    ker = ldpc_cuda.CudaLDPCDecoder(code, 25, "cuda")
    h = hashlib.sha256()
    for t in ker.decode_lane_major(xT):
        h.update(t.cpu().numpy().tobytes())
    ldpc_ms = chip_smoke._time_ms(lambda: ker.decode_lane_major(xT))
    rand = chip_smoke._ldpc_inputs(code, np.random.default_rng(7), 128,
                                   "random")
    rT = torch.from_numpy(np.ascontiguousarray(rand.T)).cuda()
    per_trials = {}
    for trials in (0, 4):
        dec = ldpc_cuda.CudaLDPCDecoder(code, trials, "cuda")
        per_trials[trials] = chip_smoke._time_ms(
            lambda: dec.decode_lane_major(rT))
    args = chip_smoke._mf_args()
    mf_ms = chip_smoke._time_ms(lambda: fir_cuda.mf_segmented(*args))
    gardner = {"gardner_ms": None, "gardner_sps4_ms": None}
    try:
        from dvbs2rx_tpu_torch.ops.frontend import SymbolSync
    except ImportError:         # a checkout from before the Gardner kernel
        SymbolSync = None
    for key, sps in (("gardner_ms", 2), ("gardner_sps4_ms", 4)):
        if SymbolSync is None:
            break
        sync = SymbolSync(sps=sps, device="cuda")
        n = 4096 * sps + sync.history() + 64
        x = torch.from_numpy(chip_smoke._gardner_waveform(
            4136, sps, seed=900, frac_delay=0.15)[None, :n]).cuda()
        st = sync.init_state(1)
        for t in sync.step(st, x, 4096)[1:]:
            h.update(t.cpu().numpy().tobytes())
        gardner[key] = chip_smoke._time_ms(lambda: sync.step(st, x, 4096))
    print(json.dumps({
        "root": root, "ldpc_ms": ldpc_ms,
        "ldpc_iter_us": (per_trials[4] - per_trials[0]) / 4 * 1e3,
        "mf_ms": mf_ms, **gardner, **_bch_times(h), **_crc8_times(h),
        **_plsync_times(), **_walk_times(), "digest": h.hexdigest()[:16]}))


def _plsync_lanes(rng, info, C, F, rows, starts, dev):
    """A (C, rows, 2) buffer of seeded noisy symbols of ``info``'s
    constellation, viewed per lane as (C, F, rows, 2), and per-lane starts
    ((C F,) int64)."""
    import numpy as np
    import torch

    m = 1 << info.n_mod
    ang = 2 * np.pi * rng.integers(0, m, (C, rows)) / m + np.pi / m
    x = np.stack([np.cos(ang), np.sin(ang)], -1) + rng.normal(
        0, 0.1, (C, rows, 2))
    buf = torch.as_tensor(x.astype(np.float32), device=dev)
    return (buf, buf[:, None].expand(C, F, rows, 2),
            torch.as_tensor(np.asarray(starts, np.int64), device=dev))


def plsync_cases(plsync_cuda):
    """The PL sync calls timed here, on the card: [(key, call, kernel
    names)], the payload's names those of ``plsync_cuda``'s checkout (one
    kernel in a checkout with ``LAUNCHES["plsync_payload"]``, else the
    statistics and demap kernels)."""
    import numpy as np
    import torch

    from dvbs2rx_tpu_torch.ops import cplx
    from dvbs2rx_tpu_torch.spec.fec_params import DVBS2_MODCODS
    from dvbs2rx_tpu_torch.spec.pls import make_pls, parse_pls
    from dvbs2rx_tpu_torch.spec.scramblers import pl_descrambling_sequence

    dev = torch.device("cuda")
    rng = np.random.default_rng(2041)
    pay_k = [f"{k}_kernel" for k in plsync_cuda.LAUNCHES
             if k != "plsync_header"]
    head_k = ["plsync_header_kernel"]

    def descr(info):
        # the default scrambling code's sequence, uploaded once a call site
        return torch.as_tensor(cplx.from_np(pl_descrambling_sequence(0)[
            : info.payload_len]).astype(np.float32), device=dev)

    cases = []
    # CCM: B = 128 lanes, frame k of channel c at k L + 90
    info = parse_pls(make_pls(4, False, False))       # QPSK 1/2 pilotless
    C, F, L, R = 64, 2, info.plframe_len, info.n_slots * 90
    rows = (F + 1) * L + 92
    buf, sym, start = _plsync_lanes(rng, info, C, F, rows,
                                    np.tile(90 + np.arange(F) * L, C), dev)
    hdr = torch.stack([buf[:, k * L: k * L + 90] for k in range(F + 1)], 1)
    pls = torch.tensor([info.plsc], device=dev)
    hdrs, plss = [hdr[:, :F], hdr[:, 1:]], [pls, pls]
    cases.append(("plsync_header", lambda: plsync_cuda.plheader(
        hdrs, plss, 90, True), head_k))
    ph = plsync_cuda.plheader(hdrs, plss)["phase"]
    B = C * F
    const, rate = DVBS2_MODCODS[info.modcod]
    args = (sym, start, info.payload_len, descr(info), ph,
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.full((B,), -1.0, device=dev), info, const, rate,
            torch.empty((R * info.n_mod, B), dtype=torch.int8, device=dev),
            torch.empty(B, device=dev), torch.empty(B, device=dev))
    x0 = torch.empty((C, R, 2), device=dev)
    cases.append(("plsync_payload", lambda f=F: plsync_cuda.payload(
        *args, x_out=x0, x_every=f), pay_k))
    # VCM: 256 lanes of a 64-channel ring, PLS 17 and 49 (piloted QPSK
    # 1/2 and 8PSK 3/5 normal), each on 64 lanes
    infos = [parse_pls(p) for p in (make_pls(4, False, True),
                                    make_pls(12, False, True))]
    Lp_max = max(i.payload_len for i in infos)
    C, F, n_sym = 64, 4, 133256
    B = C * F
    vhdr = torch.as_tensor(rng.normal(size=(21, 64, 2, 90, 2)).astype(
        np.float32), device=dev)
    hp = torch.as_tensor(rng.choice([i.plsc for i in infos], 21 * 64),
                         device=dev)
    vhdrs = [vhdr[:, :, 0], vhdr[:, :, 1]]
    cases.append(("plsync_header_vcm", lambda: plsync_cuda.plheader(
        vhdrs, [hp, hp], 90), head_k))
    r_sub = min(4096, min(64800 // i.n_mod for i in infos))
    llr8 = torch.zeros((B, 64800), dtype=torch.int8, device=dev)
    xf = torch.zeros((B, 2 * r_sub), device=dev)
    vph = torch.as_tensor(rng.uniform(-3, 3, (B, 2, 2)).astype(np.float32),
                          device=dev)
    for k, inf in enumerate(infos):
        _, vsym, vstart = _plsync_lanes(rng, inf, C, F, n_sym, rng.integers(
            0, n_sym - Lp_max, B), dev)
        const, rate = DVBS2_MODCODS[inf.modcod]
        vargs = (vsym, vstart, Lp_max, descr(inf), vph,
                 torch.ones(B, dtype=torch.bool, device=dev),
                 torch.full((B,), -1.0, device=dev), inf, const, rate,
                 llr8.t(), torch.zeros(B, device=dev),
                 torch.zeros(B, device=dev))
        vkw = dict(sel=torch.arange(B, device=dev) % 4 == k,
                   x_out=xf.view(-1, r_sub, 2), x_scale=32.0, n0_use=True)
        cases.append((f"plsync_payload_vcm_pls{inf.plsc}",
                      lambda a=vargs, kw=vkw: plsync_cuda.payload(*a, **kw),
                      pay_k))
    # the VCM step's PLHEADER launch since the walk kernel keeps the
    # books: the 256 lanes' own and next headers, no autocorrelation
    lhdr = torch.as_tensor(rng.normal(size=(2, C, F, 90, 2)).astype(
        np.float32), device=dev)
    lp = torch.as_tensor(rng.choice([i.plsc for i in infos], B), device=dev)
    cases.append(("plsync_header_vcm_lanes", lambda: plsync_cuda.plheader(
        [lhdr[0], lhdr[1]], [lp, lp]), head_k))
    return cases


def _plsync_times():
    """The PL sync kernels of the checkout at the CCM and VCM shapes: the
    profiler's device time of each call's kernels, summed, and its
    CUDA-event time."""
    import chip_smoke

    try:
        from dvbs2rx_tpu_torch.ops import plsync_cuda
    except ImportError:     # a checkout from before the PL sync kernels
        return dict.fromkeys(PLSYNC_KEYS)
    out = {}
    for key, fn, kernels in plsync_cases(plsync_cuda):
        out[f"{key}_ms"] = sum(
            chip_smoke._profiled_device_times(fn, kernels).values())
        out[f"{key}_events_ms"] = chip_smoke._time_ms(fn)
    return out


PLSYNC_KEYS = tuple(f"plsync_{k}{e}_ms" for k in (
    "header", "payload", "header_vcm", "payload_vcm_pls17",
    "payload_vcm_pls49", "header_vcm_lanes") for e in ("", "_events"))


WALK_KEYS = tuple(f"walk{k}{e}_ms" for k in ("", "_dummy")
                  for e in ("", "_events"))


def _walk_times():
    """The VCM walk kernel of the checkout on phase 6's stream state and
    on the dummy ring: the profiler's device time and the CUDA-event
    time."""
    import chip_smoke
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
    from dvbs2rx_tpu_torch.spec.pls import make_pls

    try:
        from dvbs2rx_tpu_torch.ops import vcm_walk_cuda  # noqa: F401
    except ImportError:     # a checkout from before the walk kernel
        return dict.fromkeys(WALK_KEYS)
    cfg = RxConfig(modcod="qpsk1/2", frame_size="normal", acm_vcm=True,
                   pls_expected=(make_pls(4, False, True),
                                 make_pls(12, False, True)))
    sr = VCMStreamReceiver(cfg, chip_smoke.C, chip_smoke.F, device="cuda")
    iq, _, _ = chip_smoke._vcm_stimulus(sr)
    states = chip_smoke._walk_states(sr, iq)
    walk = getattr(sr, "_walk_books", None) or sr._walk
    out = {}
    for key, case in (("walk", "stream"), ("walk_dummy", "dummy")):
        fn = (lambda st=states[case]: walk(st))
        out[f"{key}_ms"] = chip_smoke._profiled_device_ms(fn,
                                                          "vcm_walk_kernel")
        out[f"{key}_events_ms"] = chip_smoke._time_ms(fn)
    return out


TRACK_SHAPES = ("ccm", "vcm", "bench", "host_c1", "host_c8", "host16k_c1",
                "host16k_c8")
FE_KEYS = tuple(f"fe_{p}_{k}" for p in ("ccm", "vcm", "bench")
                for k in ("device_ms", "launches", "events_ms")) + (
    "frontend_msps",) + tuple(f"track_{s}_ms" for s in TRACK_SHAPES)


def _device_ms(fn, calls=10):
    """Device time of one call of fn (every kernel it launches, summed)
    and its kernel launches, from torch.profiler over ``calls`` calls after
    a warm-up round."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in ev) / 1e3 / calls,
            sum(e.count for e in ev) / calls)


def _frontend_times():
    """The checkout's shared front end: the CCM and VCM steps' _frontend
    on a seeded steady state and block, and the bench's front-end call."""
    import hashlib

    import numpy as np
    import torch

    import chip_smoke
    from dvbs2rx_tpu_torch import bench
    from dvbs2rx_tpu_torch.ops import cplx
    from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig
    from dvbs2rx_tpu_torch.rx.stream import StreamReceiver
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
    from dvbs2rx_tpu_torch.spec.pls import make_pls

    from dvbs2rx_tpu_torch.ops import ffsync_cuda
    from dvbs2rx_tpu_torch.ops.ffsync import FFSyncState

    C, F, dev = chip_smoke.C, chip_smoke.F, "cuda"
    rng = np.random.default_rng(2045)
    h, th = hashlib.sha256(), hashlib.sha256()
    out = {}
    track, launch = {}, ffsync_cuda._launch

    def capture(shape):
        """The wrapper's launch, keeping its first call's arguments (the
        wrapper looks ``_launch`` up on the module)."""
        def call(*args, **kw):
            track.setdefault(shape, lambda: launch(*args, **kw))
            return launch(*args, **kw)
        return call
    vcfg = RxConfig(modcod="qpsk1/2", frame_size="normal", acm_vcm=True,
                    pls_expected=(make_pls(4, False, True),
                                  make_pls(12, False, True)))
    for path, sr in (
            ("ccm", StreamReceiver(RxConfig(modcod="qpsk1/2",
                                            frame_size="normal"), C, F,
                                   device=dev)),
            ("vcm", VCMStreamReceiver(vcfg, C, F, device=dev))):
        st = sr.init_state_np()
        st["sbuf"][:] = rng.normal(size=st["sbuf"].shape)
        st["sfill"][:] = sr._n_fe - sr.n_in + rng.integers(0, 64, C)
        st["ff_tau"][:] = rng.uniform(0, 2, C)
        st["ff_init"][:] = 1
        st["rot_inc"][:] = 1e-3
        state = {k: torch.as_tensor(v, device=dev) for k, v in st.items()}
        iq = torch.from_numpy(rng.normal(size=(C, sr.n_in, 2)).astype(
            np.float32)).to(dev)
        fn = (lambda sr=sr, state=state, iq=iq: sr._frontend(state, iq))
        ffsync_cuda._launch = capture(path)
        new, syms, _, _ = fn()
        ffsync_cuda._launch = launch
        h.update(syms.cpu().numpy().tobytes())
        out[f"fe_{path}_device_ms"], out[f"fe_{path}_launches"] = \
            _device_ms(fn)
        out[f"fe_{path}_events_ms"] = chip_smoke._time_ms(fn)
        del sr, state, new
    cfg = RxConfig(modcod="qpsk1/2", frame_size="normal")
    _, _, noisy = bench.group_fec_stimulus(2, "normal", bench.ESN0_DB)
    sync = FeedForwardSync(sps=cfg.sps, rolloff=cfg.rolloff, device=dev)
    n_out = bench.FE_N_OUT
    n = n_out * cfg.sps + sync.history() + 64
    x = torch.as_tensor(cplx.from_np(np.stack(
        [np.resize(noisy, n).astype(np.complex64)] * C)), device=dev)
    st0 = sync.step_batched(sync.init_state(C), x, n_out)[0]
    fn = (lambda: sync.step_batched(st0, x, n_out))
    ffsync_cuda._launch = capture("bench")
    h.update(fn()[1].cpu().numpy().tobytes())
    ffsync_cuda._launch = launch
    for C_h in (1, 8):
        for name, n_out_h in (("host", 4096), ("host16k", 8140)):
            sh = FeedForwardSync(sps=cfg.sps, rolloff=cfg.rolloff,
                                 max_block=n_out_h, device=dev)
            n_h = n_out_h * cfg.sps + sh.history() + 64
            xh = torch.as_tensor(cplx.from_np(np.stack(
                [np.resize(noisy[97 * c:], n_h).astype(np.complex64)
                 for c in range(C_h)])), device=dev)
            sth = FFSyncState(
                tau=torch.linspace(0.1, 1.9, C_h, device=dev),
                rate=torch.full((C_h,), 3e-5, device=dev),
                initialized=torch.ones(C_h, dtype=torch.int32, device=dev))
            track[f"{name}_c{C_h}"] = (
                lambda sh=sh, sth=sth, xh=xh, n=n_out_h: sh._track(sth, xh, n))
    for shape in TRACK_SHAPES:
        st, taps, off, cons = track[shape]()
        for t in (st.tau, st.rate, st.initialized, taps, off, cons):
            th.update(t.cpu().numpy().tobytes())
        out[f"track_{shape}_ms"] = chip_smoke._profiled_device_ms(
            track[shape], "ffsync_track_kernel")
    out["fe_bench_device_ms"], out["fe_bench_launches"] = _device_ms(fn)
    out["fe_bench_events_ms"] = chip_smoke._time_ms(fn)
    out["frontend_msps"] = bench.measure_frontend(C, device=dev)[
        "frontend_msps"]
    out["digest"] = h.hexdigest()[:16]
    out["track_digest"] = th.hexdigest()[:16]
    return out


def _crc8_times(h):
    """The CRC-8 kernel of the checkout on phase 11's S2_B4 Tx BBFRAMEs:
    CUDA events and the profiler's device time."""
    import numpy as np

    import chip_smoke

    try:
        from dvbs2rx_tpu_torch.ops import crc8_cuda
    except ImportError:     # a checkout from before the CRC-8 kernel
        return {"crc8_ms": None, "crc8_device_ms": None}
    frames = chip_smoke._crc_inputs(
        np.random.default_rng(2032))["tx_qpsk1/2_normal"]
    for t in crc8_cuda.crc8_validity(frames):
        h.update(t.cpu().numpy().tobytes())
    fn = (lambda: crc8_cuda.crc8_validity(frames))
    return {"crc8_ms": chip_smoke._time_ms(fn),
            "crc8_device_ms": chip_smoke._profiled_device_ms(
                fn, "crc8_validity_kernel")}


def _bch_times(h):
    """The BCH decode of the checkout at phase 11's S2_B4, B = 128 shape:
    sync-free on the error batch, the default form on a clean one."""
    import numpy as np
    import torch

    import chip_smoke
    from dvbs2rx_tpu_torch.ops import bch

    try:
        from dvbs2rx_tpu_torch.ops import bch_cuda  # noqa: F401
    except ImportError:     # a checkout from before the BCH kernels
        return {"bch_ms": None, "bch_clean_ms": None}
    from dvbs2rx_tpu_torch.ops.encode import get_device_encoder

    enc = get_device_encoder("normal", "1/2", "cuda")
    fec = enc.fec
    rng = np.random.default_rng(2032)
    bits_t, _, _ = chip_smoke._fec_tail_codewords(enc, 128, rng)
    clean_t, _, _ = chip_smoke._fec_tail_codewords(enc, 128, rng, True)
    dec = bch.BCHDecoder("normal", fec.t, fec.nbch, fec.kbch, device="cuda")
    for t in dec.decode_lane_major(bits_t, True):
        h.update(t.cpu().numpy().tobytes())
    return {"bch_ms": chip_smoke._time_ms(
                lambda: dec.decode_lane_major(bits_t, True)),
            "bch_clean_ms": chip_smoke._time_ms(
                lambda: dec.decode_lane_major(clean_t))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child")
    ap.add_argument("--frontend", action="store_true")
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.frontend)
    sys.path.insert(0, str(ROOT))
    from dvbs2rx_tpu_torch import bench

    print(bench.smi(), flush=True)
    runs = []
    for _ in range(args.rounds):
        for root in args.roots + args.roots[::-1]:
            r = subprocess.run([sys.executable, __file__, "--child", root]
                               + ["--frontend"] * args.frontend,
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{root}: exit {r.returncode}\n"
                                   f"{r.stderr[-4000:]}")
            line = r.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    keys = FE_KEYS if args.frontend else (
        "ldpc_ms", "ldpc_iter_us", "mf_ms", "gardner_ms", "gardner_sps4_ms",
        "bch_ms", "bch_clean_ms", "crc8_ms", "crc8_device_ms", *PLSYNC_KEYS,
        *WALK_KEYS)
    summary = {root: {k: [x[k] for x in runs if x["root"] == root]
                      for k in keys}
               for root in args.roots}
    same = {"same_outputs": len({x["digest"] for x in runs}) == 1}
    if args.frontend:
        same["same_track_outputs"] = len({x["track_digest"]
                                          for x in runs}) == 1
    print(json.dumps({"runs": summary, **same}))


if __name__ == "__main__":
    sys.exit(main())
