#!/usr/bin/env python3
"""Kernel microbenchmarks of the PyTorch/CUDA port, mirroring the
reference's bench/cpu + bench/fec.

The counterpart of ``tools/microbench.py`` for ``dvbs2rx_tpu_torch``, with
its keys and reference numbers (BASELINE.md; single-header /
single-frame C++ on a CPU):

  pi/2-BPSK map / demap                  : 51.2 / 55.7 ns/hdr
  PLSC RM(1,6) decode, soft              : 2.57 Mb/s
  BCH decode (n=38880, k=38688, t=12)    : ~41 Mb/s (Apple M2 Max)

Here the unit is the batched device call (one header or frame per batch
row), timed by the bench's ``time_ms`` (CUDA events, median of timings of
back-to-back calls after warm-up; ``*_ms_min``/``*_ms_max`` keep the
spread): the PLSC soft decode (``ops.plsync.plsc_decode_soft``) over B
PLHEADERs, and the normal t = 12 BCH decode (``BCHDecoder``: on the card
the locator kernel, one all-clean readback and the Chien kernel) over
frames with two bit errors each and over clean frames. The pi/2-BPSK
figures are host numpy: the port's mapper and, below, a copy of the JAX
package's coherent demapper (``dvbs2rx_tpu/spec/pi2_bpsk.py``), which
the port's receivers do not use. Prints one JSON line.

Runs on the card; ``--device cpu`` runs on the CPU (a rehearsal: no time
from it is a device figure).

Usage:
    python tools/torch_microbench.py [--device cpu] [--batch 8192]
        [--bch-batch 128]
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

from dvbs2rx_tpu_torch.bench import time_ms  # noqa: E402
from dvbs2rx_tpu_torch.ops import cplx, plsync  # noqa: E402
from dvbs2rx_tpu_torch.rx.receiver import get_bch_decoder  # noqa: E402
from dvbs2rx_tpu_torch.spec import (  # noqa: E402
    bch_spec,
    pi2_bpsk,
    pl_defs,
    reed_muller,
)
from dvbs2rx_tpu_torch.spec.fec_params import get_fec_info  # noqa: E402
from dvbs2rx_tpu_torch.utils.runtime import resolve_device  # noqa: E402


# Derotation factors turning pi/2-BPSK into real 2-PAM (+1 for bit 0):
# even index: multiply by (s - js); odd index: multiply by (-s - js).
_ROT_EVEN = np.complex64(complex(pl_defs.SQRT2_2, -pl_defs.SQRT2_2))
_ROT_ODD = np.complex64(complex(-pl_defs.SQRT2_2, -pl_defs.SQRT2_2))


def derotate_bpsk(syms):
    """Rotate pi/2-BPSK symbols onto the real axis; returns real soft
    decisions, positive for bit 0 and negative for bit 1."""
    syms = np.asarray(syms)
    n = syms.shape[-1]
    rot = np.where((np.arange(n) & 1) == 0, _ROT_EVEN, _ROT_ODD)
    return np.real(syms * rot).astype(np.float32)


def demap_bpsk(syms):
    """Coherent hard demap; returns uint8 bits."""
    return (derotate_bpsk(syms) < 0).astype(np.uint8)


def encode_plheader(pls):
    plsc_bits = reed_muller.encode(pls) ^ pl_defs.PLSC_SCRAMBLER_BITS
    bits = np.concatenate([pl_defs.SOF_BITS, plsc_bits])
    return pi2_bpsk.map_bpsk(bits)


def _timed(rec, fn, dev, runs):
    """time_ms of fn() into rec's ms keys; returns the median (s)."""
    med, lo, hi = time_ms(fn, runs, 2, 1, dev)
    rec.update(ms=med, ms_min=lo, ms_max=hi)
    return med / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=8192,
                    help="PLHEADERs per PLSC decode call")
    ap.add_argument("--bch-batch", type=int, default=128,
                    help="frames per BCH decode call")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    runs = 20 if dev.type == "cuda" else 2
    B = args.batch
    rng = np.random.default_rng(0)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}

    # ---- PLSC soft decode (pi/2-BPSK derotate + RM(1,6) ML + argmax)
    pls = rng.integers(0, 128, B)
    hdrs = np.stack([encode_plheader(int(v)) for v in pls])  # (B, 90) cplx
    noisy = hdrs + 0.1 * (
        rng.normal(size=(B, 90, 2)).astype(np.float32)
        @ np.array([1, 1j], dtype=np.complex64)
    )
    x = torch.as_tensor(cplx.from_np(noisy.astype(np.complex64)), device=dev)

    def plsc_fn():
        return plsync.plsc_decode_soft(x)[0]

    rec = {}
    t = _timed(rec, plsc_fn, dev, runs)
    dec = plsc_fn().cpu().numpy()
    out["plsc_soft_decode"] = {
        "ns_per_header": t / B * 1e9,
        "mbps_info": B * 7 / t / 1e6,
        "ref_mbps": 2.57,
        "accuracy": float(np.mean(dec == pls)),
        **rec,
    }

    # ---- pi/2-BPSK spec kernels (numpy, per 90-symbol PLHEADER)
    bits = rng.integers(0, 2, (B, 90), dtype=np.uint8)
    n = min(512, B)
    t0 = time.perf_counter()
    syms = np.stack([pi2_bpsk.map_bpsk(b) for b in bits[:n]])
    t_map = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for i in range(n):
        demap_bpsk(syms[i])
    t_demap = (time.perf_counter() - t0) / n
    out["pi2_bpsk_numpy"] = {
        "map_ns_per_header": t_map * 1e9,
        "demap_ns_per_header": t_demap * 1e9,
        "ref_ns": {"map": 51.2, "demap": 55.7},
        "note": "spec-layer numpy (host); device path uses batched ops",
    }

    # ---- BCH decode, normal FECFRAME t=12 (reference ~41 Mb/s)
    fec = get_fec_info("normal", "1/2")
    dec_b = get_bch_decoder("normal", fec.t, fec.nbch, fec.kbch, dev)
    Bb = args.bch_batch
    msg_bytes = rng.integers(0, 256, (Bb, fec.kbch // 8), dtype=np.uint8)
    cw = np.stack([
        np.concatenate([
            np.unpackbits(m),
            np.unpackbits(bch_spec.bch_encode_bytes(m, "normal", fec.t)),
        ])
        for m in msg_bytes
    ])[:, : fec.nbch]
    # flip 2 random bits per frame -> exercises the whole locator + Chien
    dirty = cw.copy()
    for r in range(Bb):
        for pos in rng.integers(0, fec.nbch, 2):
            dirty[r, pos] ^= 1
    xb = torch.as_tensor(dirty, device=dev)
    xc = torch.as_tensor(cw, device=dev)
    rec_d, rec_c = {}, {}
    t_dirty = _timed(rec_d, lambda: dec_b(xb), dev, runs)
    t_clean = _timed(rec_c, lambda: dec_b(xc), dev, runs)
    corr = dec_b(xb)[0].cpu().numpy()
    out["bch_normal_t12"] = {
        "mbps_correcting": Bb * fec.kbch / t_dirty / 1e6,
        "mbps_clean": Bb * fec.kbch / t_clean / 1e6,
        "ref_mbps": 41.0,
        "all_corrected": bool(np.array_equal(corr, cw)),
        "frames": Bb,
        "correcting": rec_d, "clean": rec_c,
    }
    out["timing"] = ("CUDA events: median of 20 timings of one call after "
                     "2 warm-up calls" if dev.type == "cuda" else
                     "host clock (a CPU rehearsal)")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
