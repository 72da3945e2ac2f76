#!/usr/bin/env python3
"""Multi-device scaling of the PyTorch/CUDA port's batched receiver.

The counterpart of ``tools/scaling_bench.py`` for ``dvbs2rx_tpu_torch``.
It runs the frame-group + FEC step (``BatchedPipeline``) on channel meshes
of 1/2/4/8 devices (``parallel.batch.make_channel_mesh``) and reports the
per-step wall time and the scaling efficiency against one device.

The mesh is the distinct cards that are present (``cuda:0`` .. ``cuda:D-1``)
where the host has D of them, else ``cuda:0`` repeated; ``--device cpu``
takes ``["cpu"] * D``. Every record says which: ``devices`` (the list of
the largest mesh) and ``distinct``. On a repeated device the D shards queue
one after another on the same card or CPU, so the run measures only the
partition overhead of the sharded program, and the expected slowdown is D
(``core_oversubscription_floor``, as the JAX tool names the same floor of
its shared-core virtual mesh); scaling across cards needs several of them.

Usage:
    python tools/torch_scaling_bench.py [--device cpu] [n_channels]
        [frames_per_step]
    python tools/torch_scaling_bench.py --stream [--device cpu]
        [channels_per_device] [frames_per_step]

Both modes use short QPSK 1/2 frames, as the JAX tool does. ``--stream``
benches the composed ``StreamReceiver`` step (front end + PL + FEC +
control) sharded over the channel mesh and WEAK-scales it: C =
channels_per_device x D, so the per-device workload is constant. It
writes the table to ``build/scaling_stream_torch.json`` (the JAX tool's
is ``docs/scaling_stream.json``). Each mode prints one line per mesh and
a JSON record last.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from dvbs2rx_tpu_torch.ops import cplx  # noqa: E402
from dvbs2rx_tpu_torch.parallel.batch import (  # noqa: E402
    BatchedPipeline,
    make_channel_mesh,
)
from dvbs2rx_tpu_torch.rx.receiver import RxConfig  # noqa: E402
from dvbs2rx_tpu_torch.rx.stream import StreamReceiver  # noqa: E402
from dvbs2rx_tpu_torch.tx import (  # noqa: E402
    Transmitter,
    TxConfig,
    awgn_channel,
)
from dvbs2rx_tpu_torch.utils.runtime import resolve_device  # noqa: E402

MESH_SIZES = (1, 2, 4, 8)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "build",
                   "scaling_stream_torch.json")


def mesh_devices(D, device):
    """D devices and whether they are distinct: cuda:0..D-1 where the host
    has D cards, else the one device D times."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() >= D:
            return [torch.device("cuda", i) for i in range(D)], True
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * D, D == 1


def _wall_s(fn, devices, n):
    """Mean host seconds of fn() over n back-to-back calls, the work
    waited for on every device of the mesh before and after."""
    def wait():
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    wait()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wait()
    return (time.perf_counter() - t0) / n


def _record(devices, distinct, key="devices"):
    """Which devices a mesh took (a table row names them ``mesh``: its
    ``devices`` is the JAX tool's mesh size)."""
    return {key: [str(d) for d in devices], "distinct": distinct}


def pipeline_main(C=64, F=2, device=None):
    """The frame-group + FEC step on meshes of 1/2/4/8 devices."""
    modcod, fsz = "qpsk1/2", "short"
    cfg = RxConfig(modcod=modcod, frame_size=fsz, fec_batch=C * F)
    L = cfg.pls_info.plframe_len
    tx = Transmitter(TxConfig(modcod=modcod, frame_size=fsz))
    rng = np.random.default_rng(0)
    n_pkts = ((F + 2) * tx.df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    syms = tx.modulate_ts(pkts.reshape(-1))[: (F + 1) * L + 91]
    noisy = syms + 0.05 * (
        rng.normal(size=(syms.size, 2)).astype(np.float32)
        @ np.array([1, 1j], dtype=np.complex64)
    )
    symbols = np.stack([noisy.astype(np.complex64)] * C)

    results, table = {}, []
    for nd in MESH_SIZES:
        if C % nd:
            continue
        devices, distinct = mesh_devices(nd, device)
        mesh = make_channel_mesh(devices)
        pipe = BatchedPipeline(cfg, n_channels=C, frames_per_step=F,
                               mesh=mesh)
        h, p = pipe.frame_inputs_from_symbols(symbols)
        out = pipe.step(h, p, True)
        errs = int(out[2]["bch_errors"])
        dt = _wall_s(lambda: pipe.step(h, p, True), devices, 5)
        results[nd] = dt
        eff = results[1] / (dt * nd) if nd > 1 else 1.0
        thr = C * F * L * cfg.sps / dt / 1e6
        table.append({"devices": nd, "channels": C,
                      "step_ms": dt * 1e3, "msps": thr,
                      "scaling_efficiency": eff,
                      "core_oversubscription_floor": nd / len(set(devices)),
                      "bch_errors": errs,
                      **_record(devices, distinct, "mesh")})
        kind = "distinct" if distinct else "repeated"
        print(f"devices={nd} step={dt*1e3:.1f}ms throughput={thr:.1f} Msps "
              f"scaling_efficiency={eff:.2f} ({kind} {devices[0]})",
              flush=True)
    rec = {"mode": "pipeline", "frames_per_step": F, "table": table,
           **_record(*mesh_devices(max(r["devices"] for r in table),
                                   device)),
           "host_cores": os.cpu_count(), "note": _NOTE}
    print(json.dumps(rec), flush=True)
    return rec


_NOTE = ("channel-mesh shards driven from one process; on a repeated device "
         "the D shards queue on one card (or the CPU), so per-step time "
         "grows with D and the run measures only the partition overhead "
         "of the sharded program, not scaling across cards "
         "(core_oversubscription_floor is that expected slowdown, D over "
         "the distinct devices)")


def stream_main(cpd=8, F=2, device=None, out_path=OUT):
    """The composed StreamReceiver step, weak-scaled over the mesh."""
    txc = TxConfig(modcod="qpsk1/2", frame_size="short", sps=2, rolloff=0.2)
    tx = Transmitter(txc)
    rng = np.random.default_rng(0)
    T = 6
    results, table = {}, []
    iq1 = None
    for nd in MESH_SIZES:
        C = cpd * nd
        cfg = RxConfig(modcod="qpsk1/2", frame_size="short",
                       sym_sync_impl="ffw", fec_batch=C * F)
        devices, distinct = mesh_devices(nd, device)
        mesh = make_channel_mesh(devices)
        sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F, mesh=mesh)
        if iq1 is None:
            need = sr._n_fe + T * sr.n_in + 4096
            n_pkts = ((need // (sr.frame_len * 2) + 4) * tx.df_bytes) \
                // 188 + 2
            pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
            pkts[:, 0] = 0x47
            iq1 = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 12.0, sps=2,
                               seed=1)
        iq = np.stack([iq1] * C)
        state = sr.prime(iq[:, : sr._n_fe])
        blks = [
            sr.put_iq(cplx.from_np(
                iq[:, sr._n_fe + t * sr.n_in: sr._n_fe + (t + 1) * sr.n_in]
            ).astype(np.float32))
            for t in range(T)
        ]
        state, kb, stats = sr.step(state, blks[0])
        errs = int(stats["bch_errors"])
        box, step_errs = [state, 1], []

        def step():
            box[0], _, st = sr.step(box[0], blks[box[1]])
            box[1] += 1
            step_errs.append(st["bch_errors"])

        dt = _wall_s(step, devices, T - 1)
        errs += sum(int(e) for e in step_errs)
        results[nd] = dt
        slowdown = dt / results[1]
        floor = nd / len(set(devices))
        thr = C * sr.n_in / dt / 1e6
        table.append({"devices": nd, "channels": C,
                      "step_ms_per_device": dt * 1e3,
                      "msps_total": thr,
                      "slowdown_vs_1dev": slowdown,
                      "core_oversubscription_floor": floor,
                      "bch_errors": errs,
                      **_record(devices, distinct, "mesh")})
        print(f"devices={nd} channels={C} step={dt*1e3:.1f}ms "
              f"total={thr:.1f} Msps slowdown={slowdown:.2f}x "
              f"(oversubscription floor {floor:.1f}x) bch_errors={errs}",
              flush=True)
    big, distinct = mesh_devices(MESH_SIZES[-1], device)
    rec = {"mode": "stream", "note": "WEAK-scaling of the composed "
           "StreamReceiver IQ->BBFRAME step: channels grow with devices "
           "(constant per-device workload); " + _NOTE,
           **_record(big, distinct), "host_cores": os.cpu_count(),
           "channels_per_device": cpd, "frames_per_step": F,
           "table": table}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    print("wrote", os.path.normpath(out_path), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("sizes", type=int, nargs="*",
                    help="n_channels (or channels per device with "
                         "--stream) and frames_per_step")
    args = ap.parse_args(argv)
    if args.stream:
        return stream_main(*args.sizes, device=args.device)
    return pipeline_main(*args.sizes, device=args.device)


if __name__ == "__main__":
    main()
