#!/usr/bin/env python3
"""Device-time breakdown of the port's bare stream step on one GPU.

    python3 tools/torch_profile_step.py [--steps 3] [--path ccm|vcm]
    python3 tools/torch_profile_step.py --path ccm|vcm --by-module [--root DIR]
    python3 tools/torch_profile_step.py --path ccm --scan 8
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

``--by-module`` breaks the profiled steps' device time down by module:
the tool (not the program) wraps the step's methods and the module
functions it calls in ``torch.profiler.record_function`` ranges
(``MODULES_CCM`` / ``MODULES_VCM``; a name the checkout lacks is
skipped), and each kernel's device time goes to the innermost range
around the operator that launched it, or to "step bookkeeping" when no
range holds it (the step's own loops and merges). Prints device ms and
launches per step per module, the launching operator and kernel behind
each module's launches (all but the bookkeeping's), and one JSON line.
``--root DIR`` imports the package and ``chip_smoke`` from another
checkout (e.g. the parent unpacked under ``build/``), so two revisions
are profiled by one tool.
``--scan T`` (``ccm``) also replays ``make_scan_step(T)`` from the primed
state (one capture, then one replay under ``torch.profiler``) and prints
the replay's device busy time and kernel events per step.

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

# --by-module: (where, attribute, range name). "where" is "sr" (the
# receiver), "sr.sync", "sr.fec" or a module of the package; a kernel's
# time goes to the innermost range around the operator that launched it
MODULES_CCM = (
    ("sr", "_frontend", "front-end glue"),
    ("sr.sync", "step_batched", "O&M timing"),
    ("sr", "_windows", "windows"),
    ("sr", "_lane", "lane program (PL sync + demap)"),
    ("dvbs2rx_tpu_torch.rx.stream", "quantize_llrs", "quantize"),
    ("sr.fec", "lane_major", "FEC (LDPC + BCH)"),
    ("dvbs2rx_tpu_torch.rx.stream", "packet_validity", "CRC-8"),
    ("dvbs2rx_tpu_torch.rx.stream", "_snr_refine_frames", "SNR refinement"),
    ("sr", "_slip_metric", "slip metric"),
)
MODULES_VCM = (
    ("sr", "_append_symbols", "front-end glue"),
    ("sr.sync", "step_batched", "O&M timing"),
    ("sr", "_walk", "VCM walk"),
    ("sr", "_walk_books", "VCM walk"),
    ("dvbs2rx_tpu_torch.ops.plsync", "plheader_phase", "header phases"),
    ("dvbs2rx_tpu_torch.ops.plsync", "coarse_autocorr", "coarse autocorr"),
    ("dvbs2rx_tpu_torch.ops.plsync_cuda", "plheader", "PLHEADER kernel"),
    ("sr", "_demap_lanes", "lane program (PL sync + demap)"),
    ("sr", "_step_b", "queues + FEC"),
    ("sr", "_fec", "FEC decode (LDPC + BCH)"),
)
BOOKKEEPING = "step bookkeeping"
# The hand-written kernels are launched through ctypes with nvcc's static
# CUDA runtime, whose launches the profiler does not tie to the operator
# around them: their device time goes to a module by kernel name instead.
KERNEL_MODULES = {
    "ccm": (("mf_segmented", "O&M timing"), ("ffsync_track", "O&M timing"),
            ("frontend_", "front-end glue"), ("ldpc", "FEC (LDPC + BCH)"),
            ("bch_", "FEC (LDPC + BCH)"), ("crc8", "CRC-8"),
            ("plsync_", "lane program (PL sync + demap)")),
    "vcm": (("mf_segmented", "O&M timing"), ("ffsync_track", "O&M timing"),
            ("frontend_", "front-end glue"), ("vcm_walk", "VCM walk"),
            ("ldpc", "FEC decode (LDPC + BCH)"),
            ("bch_", "FEC decode (LDPC + BCH)"),
            ("plsync_header", "PLHEADER kernel"),
            ("plsync_", "lane program (PL sync + demap)")),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=("ccm", "vcm", "host-ccm", "host-acm",
                                       "host-gardner", "host-resample"),
                    default="ccm")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--by-module", action="store_true")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--scan", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from dvbs2rx_tpu_torch import bench
    from dvbs2rx_tpu_torch.ops import cplx
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig
    from dvbs2rx_tpu_torch.rx.stream import StreamReceiver
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    if not torch.cuda.is_available():
        raise RuntimeError("torch_profile_step needs a CUDA card")
    print(bench.smi(), flush=True)
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
    if args.scan:
        if args.path != "ccm":
            raise ValueError("--scan replays the CCM step")
        n_steps = max(n_steps, args.scan)
    if sr._n_fe + n_steps * sr.n_in > iq.shape[1]:
        raise ValueError("stimulus too short for that many steps")
    state = sr.prime(iq[:, : sr._n_fe])
    blocks = [
        sr.put_iq(cplx.from_np(
            iq[:, sr._n_fe + t * sr.n_in: sr._n_fe + (t + 1) * sr.n_in]
        ).astype(np.float32))
        for t in range(n_steps)
    ]
    if args.scan:
        _scan_profile(sr, state, blocks[: args.scan])
    for t in range(2):
        state, _, _ = sr.step(state, blocks[t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + args.steps):
        state, _, _ = sr.step(state, blocks[t])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    if args.by_module:
        _install_ranges(sr, MODULES_CCM if args.path == "ccm"
                        else MODULES_VCM)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(2 + args.steps, n_steps):
            state, _, st = sr.step(state, blocks[t])
        torch.cuda.synchronize()
    if not bool(st["locked"].all()) or (
            args.path == "ccm" and int(st["bch_errors"]) != 0):
        raise AssertionError("profiled steps lost lock or had BCH errors")
    rows = _kernel_rows(prof)
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
    if args.by_module:
        _print_by_module(args.path, prof, args.steps, busy_ms)
    if args.engine:
        _engine_profile(args, cfg, iq, sr, n_steps)


def _scan_profile(sr, primed, blocks):
    """One make_scan_step(T) replay from the primed state under
    torch.profiler: device busy time and kernel events per step."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    T = len(blocks)
    scan = sr.make_scan_step(T)
    stacked = torch.stack(blocks)
    scan(primed, stacked)                   # capture, then a replay
    torch.cuda.synchronize()
    for _ in range(5):      # a capture now and then records no kernel event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            scan(primed, stacked)
            torch.cuda.synchronize()
        rows = _kernel_rows(prof)
        if rows:
            break
    else:
        raise RuntimeError("the profiler saw no kernel of the replay")
    busy = sum(r[1] for r in rows) / 1e3 / T
    events = sum(r[2] for r in rows) / T
    print(f"ccm scan replay (make_scan_step({T})): device busy {busy:.3f} "
          f"ms/step, {events:.1f} kernel events per step")
    print(json.dumps({"scan": {"T": T, "busy_ms_per_step": busy,
                               "events_per_step": events}}))


def _install_ranges(sr, modules):
    """Wrap each (where, attribute) that exists in a record_function range
    of its name: an instance attribute on the receiver's objects, a module
    attribute on a module (looked up at call time by its callers)."""
    import functools
    import importlib

    import torch

    def wrap(fn, name):
        @functools.wraps(fn)
        def ranged(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return ranged

    for where, attr, name in modules:
        if where.startswith("sr"):
            obj = sr
            for part in where.split(".")[1:]:
                obj = getattr(obj, part)
        else:
            try:
                obj = importlib.import_module(where)
            except ImportError:
                continue
        if hasattr(obj, attr):
            setattr(obj, attr, wrap(getattr(obj, attr), name))


def _print_by_module(path, prof, steps, busy_ms):
    """Device time and launches per step of each range (innermost range
    around the launching operator), the rest as step bookkeeping; the
    kernels the profiler ties to no operator by name (KERNEL_MODULES)."""
    import json

    from torch.autograd import DeviceType

    names = {n for _, _, n in (MODULES_CCM + MODULES_VCM)}
    ms, launches, kinds = {}, {}, {}

    def add(owner, us, n, kind):
        ms[owner] = ms.get(owner, 0.0) + us / 1e3 / steps
        launches[owner] = launches.get(owner, 0) + n / steps
        per = kinds.setdefault(owner, {})
        per[kind] = per.get(kind, 0) + n

    tied = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        owner, up = BOOKKEEPING, ev
        while up is not None:
            if up.name in names:
                owner = up.name
                break
            up = up.cpu_parent
        for k in ev.kernels:
            add(owner, k.duration, 1, f"{ev.name} -> {k.name[:60]}")
            tied[k.name] = tied.get(k.name, 0) + 1
    for key, us, n in _kernel_rows(prof):
        left = n - tied.get(key, 0)
        if left <= 0:
            continue
        owner = next((m for pre, m in KERNEL_MODULES[path] if pre in key),
                     "untied kernels")
        add(owner, us * left / n, left, f"(by name) {key[:60]}")
    total = sum(ms.values())
    print(f"{path} by module: device ms and kernel launches per step "
          f"(attributed {total:.3f} of {busy_ms:.3f} busy ms)")
    for name in sorted(ms, key=lambda n: -ms[n]):
        print(f"  {ms[name]:9.3f} ms {ms[name] / total:6.1%} "
              f"{launches[name]:7.1f} launches  {name}")
        if name != BOOKKEEPING:
            # the operators and kernels behind each module's launches
            for kind, n in sorted(kinds[name].items(), key=lambda x: -x[1]):
                print(f"      {n / steps:7.2f} per step  {kind}")
    print(json.dumps({"by_module": {
        "path": path, "busy_ms": busy_ms, "attributed_ms": total,
        "modules": {n: {"ms": ms[n], "launches": launches[n],
                        "kernels": kinds[n]} for n in ms}}}))


def _kernel_rows(prof):
    """(name, device us, launches) of the kernel events: an operator's row
    repeats the time of its kernels, and a --by-module range's device-side
    annotation the time of the kernels inside it."""
    from torch.autograd import DeviceType

    ranges = {n for _, _, n in (MODULES_CCM + MODULES_VCM)}
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in ranges]


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
