#!/usr/bin/env python3
"""Time the CUDA kernels of several checkouts of this repository, in turns.

    python3 tools/torch_kernel_ab.py ROOT [ROOT ...] [--rounds 1]

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
  the Gardner kernel.

It prints one JSON line per run, with a digest of the LDPC case's four
outputs, and a last line with each checkout's times and whether every
digest agrees. The timer and the inputs come from this checkout's
``chip_smoke.py``; the kernels from each ROOT. Needs one CUDA card.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(root: str):
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve()))
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
        "mf_ms": mf_ms, **gardner, "digest": h.hexdigest()[:16]}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(chip_smoke._smi(), flush=True)
    runs = []
    for _ in range(args.rounds):
        for root in args.roots + args.roots[::-1]:
            r = subprocess.run([sys.executable, __file__, "--child", root],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{root}: exit {r.returncode}\n"
                                   f"{r.stderr[-4000:]}")
            line = r.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    summary = {root: {k: [x[k] for x in runs if x["root"] == root]
                      for k in ("ldpc_ms", "ldpc_iter_us", "mf_ms",
                                "gardner_ms", "gardner_sps4_ms")}
               for root in args.roots}
    print(json.dumps({"runs": summary,
                      "same_outputs": len({x["digest"] for x in runs}) == 1}))


if __name__ == "__main__":
    sys.exit(main())
