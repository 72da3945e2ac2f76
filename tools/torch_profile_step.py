#!/usr/bin/env python3
"""Device-time breakdown of the port's bare stream step on one GPU.

    python3 tools/torch_profile_step.py [--steps 3] [--path ccm|vcm] \
        [--root DIR]
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
device time with their share (kernel events only; the stage markers
apart). The profiled steps run with the program's stage spans on
(``dvbs2rx_tpu_torch/utils/spans.py``): the tool then splits their device
time by stage, each device event going to the stage of the last marker
before it on the stream, and prints device ms, device events and host ms
(the ``rx.<stage>`` range) per step for each stage, and one JSON line.
With ``--engine``, it then feeds the same stimulus through the path's
engine (``StreamEngine`` or ``VCMStreamEngine``) one step per ``receive``
call, once under ``torch.profiler`` with spans on (host ms per step of
each of the engine's host spans) and once under ``cProfile`` (the
engine's wall time per step and the host functions by their own time).
``--root DIR`` imports the package and ``chip_smoke`` from another
checkout (e.g. the parent unpacked under ``build/``), so two revisions
are profiled by one tool; a checkout without spans prints no split.
``--scan T`` (``ccm``) also replays ``make_scan_step(T)`` from the primed
state (the capture, then one call under ``torch.profiler``) and prints
the replay's device busy time, kernel events and stage split per step,
each event placed in its stage by the layout the capture recorded.

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
import json
import re
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MARKER = re.compile(r"rxspan_(\w+?)_kernel")
BEFORE = "(before the first marker)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--path", choices=("ccm", "vcm", "host-ccm", "host-acm",
                                       "host-gardner", "host-resample"),
                    default="ccm")
    ap.add_argument("--engine", action="store_true")
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
    with _spans_on(), profile(activities=[ProfilerActivity.CPU,
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
    _print_spans(args.path, prof, args.steps)
    if args.engine:
        _engine_profile(args, cfg, iq, sr, n_steps)


def _scan_profile(sr, primed, blocks):
    """One make_scan_step(T) replay from the primed state under
    torch.profiler: device busy time, kernel events and the stage split
    per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    T = len(blocks)
    scan = sr.make_scan_step(T)
    stacked = torch.stack(blocks)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    state = scan(primed, stacked)[0]        # the capture, then a replay
    for _ in range(5):      # a capture now and then records no kernel event
        with profile(activities=activities) as prof:
            scan(state, stacked)
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
    layout = getattr(scan._graphs[0], "layout", None)
    split = _print_spans(f"ccm scan T={T}", prof, T,
                         layout.stages if layout else None)
    print(json.dumps({"scan": {"T": T, "busy_ms_per_step": busy,
                               "events_per_step": events,
                               "stages": split}}))


def _spans_on():
    """The program's stage spans on (a checkout without them: nothing)."""
    import contextlib

    try:
        from dvbs2rx_tpu_torch.utils import spans
    except ImportError:
        return contextlib.nullcontext()
    return spans.switch(True)


def _kernel_rows(prof):
    """(name, device us, launches) of the kernel events, the stage markers
    and the spans' device-side annotations (``rx.<stage>``) apart: an
    operator's row repeats the time of its kernels, an annotation the time
    of the kernels inside it."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not MARKER.search(e.key) and not e.key.startswith("rx.")]


def _span_split(prof, stages=None):
    """{stage: [device us, device events, host us]} of a profile: each
    device event (kernel, copy, fill) goes to the stage of the last
    marker before it on the stream, events before the first marker to
    BEFORE; with ``stages`` (a scan graph's ``layout.stages``, one
    profiled call) the replay's events are placed by the layout instead
    (``spans.place``), the copies before them in ``inputs``. Host us is
    the time inside the ``rx.<stage>`` ranges. Empty without markers, or
    where the call does not fit the layout."""
    from torch.autograd import DeviceType

    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("rx.")),
                 key=lambda e: e.time_range.start)
    out, stage = {}, BEFORE
    if stages is not None:
        from dvbs2rx_tpu_torch.utils import spans

        kinds = [1 if e.name.startswith("Memcpy") else
                 2 if e.name.startswith("Memset") else 0 for e in dev]
        placed = spans.place(kinds, stages)
        if placed is None:
            print(f"the profiled call's {len(dev)} device events do not fit "
                  f"the scan's layout")
            return {}
        placed = [p or "inputs" for p in placed]
    for k, e in enumerate(dev):
        m = MARKER.search(e.name)
        if m and stages is None:
            stage = m.group(1)
            out.setdefault(stage, [0.0, 0, 0.0])
            continue
        if stages is not None:
            stage = placed[k]
        row = out.setdefault(stage, [0.0, 0, 0.0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
    if len(out) <= 1:
        return {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("rx.") \
                and e.name[3:] in out:
            out[e.name[3:]][2] += e.time_range.elapsed_us()
    return out


def _print_spans(label, prof, steps, stages=None):
    """The stage split per step; returns it as {stage: {device_ms,
    events, host_ms}}."""
    split = _span_split(prof, stages)
    if not split:
        print(f"{label}: no stage split (a program without spans)")
        return {}
    dev_ms = sum(r[0] for r in split.values()) / 1e3 / steps
    print(f"{label} by stage span (per step; device {dev_ms:.3f} ms, the "
          f"markers' own time apart):")
    out = {}
    for stage, (us, n, host) in split.items():
        out[stage] = {"device_ms": us / 1e3 / steps, "events": n / steps,
                      "host_ms": host / 1e3 / steps}
        print(f"  {us / 1e3 / steps:9.4f} ms device {n / steps:8.1f} "
              f"events {host / 1e3 / steps:9.4f} ms host  {stage}")
    print(json.dumps({"stages": {"path": label, "steps": steps,
                                 "split": out}}))
    return out


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
    """The engine's receive, one step per call: half the steps under
    torch.profiler with spans on (the host spans), half under cProfile."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dvbs2rx_tpu_torch.rx.stream import StreamEngine
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamEngine

    kind = StreamEngine if args.path == "ccm" else VCMStreamEngine
    eng = kind(cfg, n_channels=sr.n_channels, frames_per_step=2,
               device="cuda")
    eng.receive(iq[:, : sr._n_fe + sr.n_in], flush=False)    # prime + step
    eng.receive(iq[:, sr._n_fe + sr.n_in: sr._n_fe + 2 * sr.n_in],
                flush=False)
    torch.cuda.synchronize()

    def feed(ts):
        for t in ts:
            a = sr._n_fe + t * sr.n_in
            eng.receive(iq[:, a: a + sr.n_in], flush=False)
        torch.cuda.synchronize()

    half = (n_steps - 2) // 2
    with _spans_on(), profile(activities=[ProfilerActivity.CPU],
                              **_all_threads()) as tprof:
        feed(range(2, 2 + half))
    host = {}
    for e in tprof.events():
        if e.name.startswith("rx."):
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"{args.path} engine host spans (ms per receive step, {half} "
          f"steps): " + (", ".join(f"{k} {v / 1e3 / half:.3f}"
                                   for k, v in sorted(host.items()))
                         or "none (a program without spans)"))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    feed(range(2 + half, n_steps))
    prof.disable()
    steps = n_steps - 2 - half
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


def _all_threads():
    """torch.profiler's option to record every thread's ranges (the
    engine's reader thread)."""
    from torch._C._profiler import _ExperimentalConfig

    return {"experimental_config":
            _ExperimentalConfig(profile_all_threads=True)}


if __name__ == "__main__":
    sys.exit(main())
