#!/usr/bin/env python3
"""Tx -> channel -> Rx loopback simulation on the PyTorch/CUDA port
(``examples/loopback_sim.py`` on ``dvbs2rx_tpu_torch``).

Run: python examples/torch_loopback_sim.py [--modcod qpsk3/5] [--esn0 8]
     [--cfo 1e-4] [--cpu]

The receiver runs on the card unless ``--cpu`` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modcod", default="qpsk3/5")
    ap.add_argument("--frame-size", default="short")
    ap.add_argument("--pilots", action="store_true", default=True)
    ap.add_argument("--esn0", type=float, default=10.0)
    ap.add_argument("--cfo", type=float, default=0.0)
    ap.add_argument("--packets", type=int, default=120)
    ap.add_argument("--cpu", action="store_true",
                    help="run the receiver on the CPU instead of the card")
    args = ap.parse_args(argv)

    from dvbs2rx_tpu_torch.rx.receiver import RxConfig, make_receiver
    from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig, awgn_channel

    rng = np.random.default_rng(0)
    ts = rng.integers(0, 256, (args.packets, 188), dtype=np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F

    tx = Transmitter(TxConfig(modcod=args.modcod, frame_size=args.frame_size,
                              pilots=args.pilots))
    iq = awgn_channel(tx.ts_to_iq(ts.reshape(-1)), args.esn0, sps=2,
                      freq_offset=args.cfo)
    rx = make_receiver(RxConfig(modcod=args.modcod,
                                frame_size=args.frame_size,
                                pilots=args.pilots),
                       device="cpu" if args.cpu else None)
    out = rx.receive(iq)

    n_out = out.size // 188
    ok = False
    if n_out:
        hits = np.where((ts == out[:188]).all(axis=1))[0]
        if hits.size:
            k = hits[0]
            ok = np.array_equal(out, ts[k: k + n_out].reshape(-1)[: out.size])
    print(f"recovered {n_out}/{args.packets} packets, bit-exact: {ok}")
    for key, val in rx.stats.as_dict().items():
        print(f"  {key}: {val}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
