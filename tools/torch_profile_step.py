#!/usr/bin/env python3
"""Device-time breakdown of the port's bare stream step on one GPU.

    python3 tools/torch_profile_step.py [--steps 3] [--path ccm|vcm]
    python3 tools/torch_profile_step.py --path host-ccm|host-acm
    python3 tools/torch_profile_step.py --path host-gardner|host-resample

Builds chip_smoke.py's configuration and stimulus of one path: ``ccm``
(phase 5: 64 channels, QPSK 1/2 normal pilotless at Es/N0 6 dB, a
``StreamReceiver``) or ``vcm`` (phase 6: 64 channels, piloted QPSK 1/2 +
8PSK 3/5 normal at 13 dB, a ``VCMStreamReceiver``), 2 frames per step.
Primes the receiver, puts every input block on the card, runs two
warm-up steps, ``--steps`` timed steps (host clock, ending in a
synchronise) and ``--steps`` more under ``torch.profiler``. Prints the
bare step's wall time, the device busy time per step (the sum of the
kernels' device times; one stream, so they do not overlap), the idle
share of the bare step, the kernel launches per step, and the kernels by
device time with their share (kernel events only). With ``--engine``, it
then feeds the same stimulus through the path's engine (``StreamEngine``
or ``VCMStreamEngine``) one step per ``receive`` call under ``cProfile``
and prints the engine's wall time per step and the host functions by
their own time.

``host-ccm`` and ``host-acm`` profile a host receiver instead: chip_smoke
phase 7's (a) ``Receiver`` or (b) blind ``ACMReceiver`` run, whole (every
chunk and the flush), once timed (host clock), once under
``torch.profiler`` (device busy, idle share, launches, kernels by device
time) and once under ``cProfile`` (host functions by own time), each on a
fresh receiver after one warm-up run. ``host-gardner`` and
``host-resample`` do the same for phase 8's (d) ``Receiver`` with Gardner
timing and (f) ``DeviceResampler(0.8)`` in front of the ``ffw``
``Receiver``; every host path also reports the kernel launches per
front-end block. Needs one CUDA card.
"""

import argparse
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=("ccm", "vcm", "host-ccm", "host-acm",
                                       "host-gardner", "host-resample"),
                    default="ccm")
    ap.add_argument("--engine", action="store_true")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from dvbs2rx_tpu_torch.ops import cplx
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig
    from dvbs2rx_tpu_torch.rx.stream import StreamReceiver
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    if not torch.cuda.is_available():
        raise RuntimeError("torch_profile_step needs a CUDA card")
    print(chip_smoke._smi(), flush=True)
    if args.path.startswith("host-"):
        return _host_profile(args.path)
    if args.path == "ccm":
        cfg = RxConfig(modcod="qpsk1/2", frame_size="normal")
        sr = StreamReceiver(cfg, n_channels=chip_smoke.C,
                            frames_per_step=chip_smoke.F, device="cuda")
        iq, _ = chip_smoke._stimulus(types.SimpleNamespace(sr=sr))
    else:
        cfg = RxConfig(modcod="qpsk1/2", frame_size="normal", acm_vcm=True,
                       pls_expected=(17, 49))
        sr = VCMStreamReceiver(cfg, n_channels=chip_smoke.C,
                               frames_per_step=chip_smoke.F, device="cuda")
        iq, _, _ = chip_smoke._vcm_stimulus(sr)
    n_steps = 2 + 2 * args.steps
    if sr._n_fe + n_steps * sr.n_in > iq.shape[1]:
        raise ValueError("stimulus too short for that many steps")
    state = sr.prime(iq[:, : sr._n_fe])
    blocks = [
        sr.put_iq(cplx.from_np(
            iq[:, sr._n_fe + t * sr.n_in: sr._n_fe + (t + 1) * sr.n_in]
        ).astype(np.float32))
        for t in range(n_steps)
    ]
    for t in range(2):
        state, _, _ = sr.step(state, blocks[t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + args.steps):
        state, _, _ = sr.step(state, blocks[t])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(2 + args.steps, n_steps):
            state, _, st = sr.step(state, blocks[t])
        torch.cuda.synchronize()
    if not bool(st["locked"].all()) or (
            args.path == "ccm" and int(st["bch_errors"]) != 0):
        raise AssertionError("profiled steps lost lock or had BCH errors")
    # kernels only: an operator's row repeats the time of its kernels
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if busy == 0:
        raise RuntimeError("the profiler saw no device time")
    busy_ms = busy / 1e3 / args.steps
    launches = sum(r[2] for r in rows) / args.steps
    print(f"{args.path} bare step wall {wall * 1e3:.3f} ms ({args.steps} "
          f"steps); device busy {busy_ms:.3f} ms/step ({args.steps} profiled "
          f"steps); idle {1 - busy_ms / (wall * 1e3):.1%} of the bare step; "
          f"{launches:.0f} kernel launches per step")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"  {us / 1e3:9.3f} ms {us / busy:6.1%} {n:6d} launches  "
              f"{key[:90]}")
    if args.engine:
        _engine_profile(args, cfg, iq, sr, n_steps)


def _kernel_rows(prof):
    """(name, device us, launches) of the kernel events: an operator's row
    repeats the time of its kernels."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def _host_profile(path):
    """One host receiver run of chip_smoke phase 7 (a), (b) or phase 8 (d),
    (f): wall, device busy and launches (per front-end block too) under
    torch.profiler, host functions under cProfile."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from dvbs2rx_tpu_torch.ops.resample import DeviceResampler
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig, make_receiver

    resample = None
    if path == "host-ccm":
        cfg = RxConfig(modcod="qpsk1/2", frame_size="normal")
        iq, _ = chip_smoke._ccm_host_stimulus()
    elif path == "host-gardner":
        cfg = RxConfig(modcod="qpsk1/2", frame_size="normal",
                       sym_sync_impl="gardner")
        iq, _ = chip_smoke._ccm_host_stimulus(delay=chip_smoke.OS_DELAY)
    elif path == "host-resample":
        cfg = RxConfig(modcod="qpsk1/2", frame_size="normal")
        iq, _ = chip_smoke._ccm_host_stimulus(sps=chip_smoke.OS_TX_SPS_F)
        resample = 2.0 / chip_smoke.OS_TX_SPS_F
    else:
        cfg = RxConfig(modcod="qpsk1/2", frame_size="normal", pilots=True,
                       acm_vcm=True)
        iq = chip_smoke._acm_stimulus([500])[0][0]
    n_chunks = (chip_smoke.ACM_CHUNKS if path == "host-acm"
                else chip_smoke.HOST_CHUNKS)
    chunks = np.array_split(iq, n_chunks)
    blocks = []

    def run():
        rx = make_receiver(cfg)
        calls = chip_smoke._count_calls(rx)
        rs = DeviceResampler(resample) if resample else None
        for c in chunks:
            rx.receive(rs(c) if rs else c, flush=False)
        rx.receive(rs.flush() if rs else np.empty(0, np.complex64),
                   flush=True)
        torch.cuda.synchronize()
        if rx.stats.bch_frame_errors or not rx.stats.locked:
            raise AssertionError(f"{path}: {rx.stats}")
        blocks.append(calls["fe"])
        return rx

    run()                                             # warm-up
    t0 = time.perf_counter()
    rx = run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = _kernel_rows(prof)
    busy = sum(r[1] for r in rows) / 1e6
    if busy == 0:
        raise RuntimeError("the profiler saw no device time")
    frames = rx.stats.bch_frames
    launches = sum(r[2] for r in rows)
    print(f"{path}: {iq.size} samples, {frames} FEC frames, {blocks[-1]} "
          f"front-end blocks; run wall {wall:.3f} s = "
          f"{iq.size / wall / 1e6:.3f} Msps; device busy "
          f"{busy * 1e3:.2f} ms, idle {1 - busy / wall:.1%} of the run; "
          f"{launches} kernel launches ({launches / frames:.0f} per frame, "
          f"{launches / blocks[-1]:.1f} per front-end block)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {us / 1e6 / busy:6.1%} {n:6d} launches  "
              f"{key[:90]}")
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    print(f"{path}: host functions by own time (ms per run):")
    st = pstats.Stats(prof)
    for (fn, line, name), (_, ncalls, tt, ct, _) in sorted(
            st.stats.items(), key=lambda kv: -kv[1][2])[:15]:
        print(f"  {tt * 1e3:8.2f} ms own {ct * 1e3:8.2f} ms cum {ncalls:7d} "
              f"calls  {Path(fn).name}:{line} {name}")


def _engine_profile(args, cfg, iq, sr, n_steps):
    """The engine's receive, one step per call, under cProfile."""
    import cProfile
    import pstats

    import torch
    from dvbs2rx_tpu_torch.rx.stream import StreamEngine
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamEngine

    kind = StreamEngine if args.path == "ccm" else VCMStreamEngine
    eng = kind(cfg, n_channels=sr.n_channels, frames_per_step=2,
               device="cuda")
    eng.receive(iq[:, : sr._n_fe + sr.n_in], flush=False)    # prime + step
    eng.receive(iq[:, sr._n_fe + sr.n_in: sr._n_fe + 2 * sr.n_in],
                flush=False)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for t in range(2, n_steps):
        a = sr._n_fe + t * sr.n_in
        eng.receive(iq[:, a: a + sr.n_in], flush=False)
    torch.cuda.synchronize()
    prof.disable()
    steps = n_steps - 2
    print(f"{args.path} engine: {(time.perf_counter() - t0) / steps * 1e3:.2f}"
          f" ms per receive step under cProfile ({steps} steps); host "
          f"functions by own time per step:")
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    for (fn, line, name), (_, ncalls, tt, ct, _) in rows:
        print(f"  {tt / steps * 1e3:8.2f} ms own {ct / steps * 1e3:8.2f} ms "
              f"cum {ncalls / steps:8.0f} calls  {Path(fn).name}:{line} "
              f"{name}")
    if hasattr(eng, "close"):
        eng.close()


if __name__ == "__main__":
    sys.exit(main())
