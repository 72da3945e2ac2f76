#!/usr/bin/env python3
"""Time the port's bench VCM section of several checkouts, in turns.

    python3 tools/torch_vcm_ab.py ROOT [ROOT ...] [--rounds 1] [--steps 40]

Each round runs the checkouts in the order given and then in reverse, every
run in a process of its own that imports that checkout's package (and
builds its kernels) and runs its ``bench.measure_vcm`` at the bench's
configuration (64 channels, piloted QPSK 1/2 + 8PSK 3/5 normal frames at
13 dB, 2 frames a step, W = ``--steps`` chained steps, the device-staged
periodic stimulus; the section keeps every output on the card and
stitches no TS). Prints one JSON line per run (``vcm_step_ms``,
``vcm_sustained_msps``, their ``_min``/``_max``, the integrity keys and
the card) and a last line with each checkout's values. Needs one CUDA
card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("vcm_step_ms", "vcm_step_ms_min", "vcm_step_ms_max",
        "vcm_sustained_msps", "vcm_bch_errors", "vcm_frames_ratio",
        "vcm_ok")


def child(root: str, steps: int):
    sys.path.insert(0, str(Path(root).resolve()))
    from dvbs2rx_tpu_torch import bench

    rec = bench.measure_vcm(64, 2, steps, device="cuda")
    print(json.dumps({"root": root, **{k: rec.get(k) for k in KEYS},
                      "card": bench.smi()}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.steps)
    runs = []
    for _ in range(args.rounds):
        for root in args.roots + args.roots[::-1]:
            r = subprocess.run([sys.executable, __file__, "--child", root,
                                "--steps", str(args.steps)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{root}: exit {r.returncode}\n"
                                   f"{r.stderr[-4000:]}")
            line = r.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    print(json.dumps({"runs": {root: {k: [x[k] for x in runs
                                          if x["root"] == root]
                                      for k in KEYS}
                               for root in args.roots}}))


if __name__ == "__main__":
    sys.exit(main())
