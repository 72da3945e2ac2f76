#!/usr/bin/env python3
"""Frame-sync timing metric demo on the PyTorch/CUDA port
(``examples/pl_sync_demo.py`` on ``dvbs2rx_tpu_torch``): prints the peaks
of the dense SOF+PLSC metric over a noisy PLFRAME stream.

Run: python examples/torch_pl_sync_demo.py [--cpu]

The metric runs on the card unless ``--cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the metric on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    from dvbs2rx_tpu_torch.ops import cplx, plsync
    from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig
    from dvbs2rx_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(0)
    ts = rng.integers(0, 256, (40, 188), dtype=np.uint8)
    ts[:, 0] = 0x47
    syms = tx.modulate_ts(ts.reshape(-1))
    noisy = syms + (rng.normal(0, 0.2, (syms.size, 2))
                    @ [1, 1j]).astype(np.complex64)

    metric, _, _ = plsync.timing_metric(
        torch.as_tensor(cplx.from_np(noisy[:20000]), device=dev),
        torch.zeros((90, 2), dtype=torch.float32, device=dev),
    )
    metric = metric.cpu().numpy()
    peaks = np.where(metric > plsync.THRESHOLD_UNLOCKED)[0]
    L = tx.cfg.pls_info.plframe_len
    print(f"PLFRAME length: {L} symbols")
    print(f"metric peaks at: {peaks[:8].tolist()}")
    print(f"peak spacing:    {np.diff(peaks[:8]).tolist()} (expect {L})")
    return 0 if (np.diff(peaks[:8]) == L).all() and peaks.size >= 2 else 1


if __name__ == "__main__":
    sys.exit(main())
