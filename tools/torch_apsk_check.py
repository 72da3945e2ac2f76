#!/usr/bin/env python3
"""One eager step of the piloted 16APSK cell held to the benchmark's plain
payload reference, at the cell's widths.

    python3 tools/torch_apsk_check.py [--seed N] [--steps 24] [--block 16] \
        [--scan 8] [--device cuda]
    python3 tools/torch_apsk_check.py --device cpu --short   # a rehearsal

Builds the cell ``ccm-16apsk34-64ch-13db`` as ``rxbench/run.py`` does (the
configuration, its traffic ring from ``--seed``, the prime and lock of
``rxbench/drivers/stream_scan.py``), runs ``--steps`` eager steps on the
ring's next blocks (by 24 the coarse CFO stage has fired on every
channel, so the pilot-mode fine CFO's ramp is applied), then one more,
recording what the step hands its lane program (the symbols, the
per-lane payload starts, the coarse-corrected flags, the carried N0),
what the program returns (int8 LLRs, fine CFO, data-aided N0, frame 0's
corrected symbols), the LDPC decoder's per-frame outputs and bits, and
the SNR refinement. ``rxbench/reference/payload.py`` (float64) then
processes each lane's frame from its PLHEADER, ``--block`` lanes at a
time.

Prints one JSON line (also written to ``build/apsk_check.json``):
``llr_ties`` (LLRs one apart) and ``llr_max_gap`` over every lane,
``fine_max_gap`` (cycles a symbol), ``n0_max_rel``, ``x0_max_gap``,
``snr_refined_max_rel`` against the reference's refinement of the
program's own corrected symbols and bits (``snr_refined_ref_xfec_max_rel``:
of the reference's symbols), the step's ``ldpc_frame_iters`` and
``ldpc_converged`` beside the decoder's per-frame outputs summed, the mean
iterations a frame, and the step's BCH failures. Then, from the state
after the checked step, ``--scan`` eager steps with the decoder's
per-frame outputs kept, and one ``make_scan_step`` call (on the card a
CUDA-graph replay) of the same blocks from the same state: its summed
counters beside the decoder's (``scan_*``). ``--short`` cuts the cell to
2 channels of short frames, as the CPU rehearsals do.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "ccm-16apsk34-64ch-13db"
SHORT = {"channels": 2, "rx": {"frame_size": "short", "fec_batch": 4},
         "tx": [{"modcod": "16apsk3/4", "frame_size": "short",
                 "pilots": True}]}


def _record(obj, name, store):
    """Wrap ``obj.name`` so each call's arguments and result are kept."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.append((args, kw, out))
        return out

    setattr(obj, name, wrapped)


def _scan_counters(sr, state, blocks):
    """The counters of one scan call against the decoder's per-frame
    outputs over the same blocks, stepped eagerly from the same state."""
    frames = []
    _record(sr.fec.ldpc, "decode_frames", frames)
    st = state
    for t in range(blocks.shape[0]):
        st, _, _ = sr._step(st, blocks[t], sync_free=True)
    del sr.fec.ldpc.decode_frames                   # the class's method again
    _, _, stats = sr.make_scan_step(blocks.shape[0])(state, blocks)
    return {"scan_ldpc_frame_iters": int(stats["ldpc_frame_iters"]),
            "scan_decoder_frame_iters_sum": sum(int(o[2].sum())
                                                for _, _, o in frames),
            "scan_ldpc_converged": int(stats["ldpc_converged"]),
            "scan_decoder_converged_sum": sum(int(o[3].sum())
                                              for _, _, o in frames)}


def check(seed, steps, block, device, short=False, scan=8):
    from rxbench import spec
    from rxbench.reference import payload as ref
    from rxbench.stimulus import Stimulus

    bench = spec.load_bench(ROOT)
    cell = spec.cell(bench, CELL, ROOT, SHORT if short else None,
                     {"lock_steps": 8} if short else None)
    dev = torch.device(device)
    stim = Stimulus(cell.config, cell.traffic, seed, dev)
    drv = spec.driver(cell.config["driver"]).Driver(
        cell.config, cell.traffic, stim, dev)
    sr = drv.sr
    state = drv.state
    for k in range(steps):
        state, _, _ = sr._step(state, drv.ring[(drv.block + k) % drv.S],
                               sync_free=False)
    lanes, fecs = [], []
    _record(sr, "_lane", lanes)
    _record(sr.fec, "lane_major", fecs)
    blk = drv.ring[(drv.block + steps) % drv.S]
    t0 = time.perf_counter()
    after, _, stats = sr._step(state, blk, sync_free=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    (own, _nxt, sym, start, cc, n0_ov), kw, out = lanes[0]
    kbytes, n_corr, frame_iters, ok, hard_t = fecs[0][2]
    C, F, L = sr.n_channels, sr.F, sr.frame_len
    B = C * F
    pls = sr.cfg.pls
    syms = sym[:, 0].cpu()                             # (C, rows, 2)
    first = (start - 90).cpu()
    llrs = out["llrs"].t().cpu()                       # (B, N)
    gaps = {"ties": 0, "max": 0, "fine": 0.0, "n0": 0.0, "x0": 0.0}
    ref_x0 = []
    for a in range(0, B, block):
        b = torch.arange(a, min(a + block, B))
        rows = first[b][:, None] + torch.arange(L)[None]
        frames = syms[b // F][torch.arange(b.numel())[:, None], rows]
        want = ref.frame_payload(frames, pls, n0_ov.cpu()[b].double(),
                                 cc.cpu()[b])
        d = llrs[b].to(torch.int64) - want["llrs"].to(torch.int64)
        gaps["ties"] += int((d != 0).sum())
        gaps["max"] = max(gaps["max"], int(d.abs().max()))
        gaps["fine"] = max(gaps["fine"], float(
            (out["fine"].cpu()[b].double() - want["fine"]).abs().max()))
        gaps["n0"] = max(gaps["n0"], float(
            (out["n0"].cpu()[b].double() / want["n0"] - 1).abs().max()))
        f0 = (b % F) == 0
        x0 = out["x0"].cpu()[b[f0] // F].double()
        xr = want["xfec"][f0][:, : x0.shape[1]]
        gaps["x0"] = max(gaps["x0"], float(
            (torch.complex(x0[..., 0], x0[..., 1]) - xr).abs().max()))
        ref_x0.append(want["xfec"][f0])
    bits0 = hard_t[:, ::F].t().cpu()                    # (C, N)
    snr = stats["snr_refined"].cpu().double()
    snr_prog, _ = ref.snr_refine(out["x0"].cpu(), bits0, pls)
    snr_refx, _ = ref.snr_refine(torch.cat(ref_x0), bits0, pls)
    it = frame_iters.cpu()
    res = {
        "cell": CELL, "seed": seed, "steps_before": steps,
        "device": str(dev),
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "lanes": B, "llrs": int(llrs.numel()),
        "llr_ties": gaps["ties"], "llr_max_gap": gaps["max"],
        "fine_max_gap": gaps["fine"], "n0_max_rel": gaps["n0"],
        "x0_max_gap": gaps["x0"],
        "snr_refined_max_rel": float((snr / snr_prog - 1).abs().max()),
        "snr_refined_ref_xfec_max_rel": float(
            (snr / snr_refx - 1).abs().max()),
        "snr_refined_db_mean": float(10 * torch.log10(snr).mean()),
        "ldpc_frame_iters": int(stats["ldpc_frame_iters"]),
        "decoder_frame_iters_sum": int(it.sum()),
        "ldpc_converged": int(stats["ldpc_converged"]),
        "decoder_converged_sum": int(ok.sum()),
        "iters_per_frame": float(it.double().mean()),
        "iters_max": int(it.max()), "ldpc_iters": int(stats["ldpc_iters"]),
        "bch_failed": int((n_corr < 0).sum()),
        "coarse_corrected": int(cc.sum()),
        "n0_carried": int((n0_ov > 0).sum()), "step_s": step_s,
    }
    if scan:
        nxt = torch.arange(steps + 1, steps + 1 + scan) + drv.block
        res.update(_scan_counters(sr, after, drv.ring[nxt % drv.S]))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--scan", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--short", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from dvbs2rx_tpu_torch.utils.runtime import exact_fp32

        exact_fp32()
    res = check(args.seed, args.steps, args.block, args.device, args.short,
                args.scan)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "apsk_check.json").write_text(json.dumps(res) + "\n")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
