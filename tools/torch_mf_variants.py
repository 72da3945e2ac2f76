#!/usr/bin/env python3
"""Time design variants of the matched-filter kernel in one process.

    python3 tools/torch_mf_variants.py [--rounds 2] [NAME ...]

Each variant is ``dvbs2rx_tpu_torch/csrc/mf_segmented.cu`` with other
values of its constants (threads per block, outputs per thread, ring
depth) and text edits (``EDITS``): the FIR arithmetic taken out
(``nofir``: the window fetch, staging and stores alone, which measures the
load pipeline), a grid that gives every block the same number of items
(``balanced``), the window copies without their 256-byte L2 prefetch
hint (``no_prefetch``). All
variants build in parallel with the package's nvcc flags into
``build/mf_variants/`` and run on ``chip_smoke.py``'s main-path inputs
(64 x 15 x 4,332 outputs, 21 taps, sps 2) through their own library's
``mf_segmented_launch``, with the work plan of ``fir_cuda.launch_plan``
at their constants. Every variant with arithmetic is held to
``mf_segmented_plain`` within chip_smoke's tolerance. Each round times
the variants in order and then in reverse with ``chip_smoke._time_ms``
(50 timings of 10 back-to-back calls), beside the package's own wrapper
(``fir_cuda.mf_segmented``, whose host work is timed alone too) and two
device-memory yardsticks on the same tensors: ``x.sum()`` (reads the
66.6 MB input) and a 33.3 MB ``copy_`` of the output. Prints one JSON
line per variant (ptxas registers and stack, blocks per SM, times, share
of the HBM bound) and a summary line. Needs one CUDA card.
"""

import argparse
import json
import re
import sys
import time

from torch_variant_common import ROOT, apply_edits, bind, build, time_in_turns

# name: [(old text, new text), ...]
EDITS = {
    "nofir": [(f"fir2<LMAX, {sh}>(win, t, re, im);", "(void)win;")
              for sh in (0, 1)],
    "balanced": [(
        "  const int grid = (int)(items < blocks ? items : blocks);",
        "  const long long rounds = (items + blocks - 1) / blocks;\n"
        "  const int grid = (int)((items + rounds - 1) / rounds);")],
    "no_prefetch": [("cp.async.cg.shared.global.L2::256B [",
                     "cp.async.cg.shared.global [")],
}
# name: (threads, outputs per thread, ring depth, edits); the first is the
# source as it stands
VARIANTS = {
    "t128_r8_s2": (128, 8, 2, ()),
    "no_prefetch": (128, 8, 2, ("no_prefetch",)),
    "t128_r8_s3": (128, 8, 3, ()),
    "t128_r8_s4": (128, 8, 4, ()),
    "t64_r8_s2": (64, 8, 2, ()),
    "t256_r8_s2": (256, 8, 2, ()),
    "t128_r16_s2": (128, 16, 2, ()),
    "balanced": (128, 8, 2, ("balanced",)),
    "nofir": (128, 8, 2, ("nofir",)),
}


def variant_source(text, threads, r, stages, edits):
    for name, val in (("kThreads", threads), ("kR", r), ("kStages", stages)):
        text, k = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {val};", text)
        assert k == 1, name
    for edit in edits:
        text = apply_edits(text, EDITS[edit])
    return text


def build_variants(names):
    from dvbs2rx_tpu_torch import _build

    src = (_build.SRC_DIR / "mf_segmented.cu").read_text()
    libs, logs = build(ROOT / "build" / "mf_variants",
                       {name: variant_source(src, *VARIANTS[name])
                        for name in names})
    reports = {}
    for name, lib in libs.items():
        bind(lib, _build._SIGNATURES, "mf_segmented")
        reports[name] = {
            k.split("mf_segmented_kernel")[1][:14]: v
            for k, v in _build.ptxas_report(logs[name]).items()}
    return libs, reports


def plan_for(name, C, S, seg_len, L, sps):
    from dvbs2rx_tpu_torch.ops import fir_cuda

    threads, r, stages, _ = VARIANTS[name]
    saved = (fir_cuda.CHUNK_MAX, fir_cuda.STAGES)
    fir_cuda.CHUNK_MAX, fir_cuda.STAGES = threads * r, stages
    try:
        return fir_cuda.launch_plan(C, S, seg_len, L, sps)
    finally:
        fir_cuda.CHUNK_MAX, fir_cuda.STAGES = saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    names = args.names or list(VARIANTS)

    import torch

    import chip_smoke
    from dvbs2rx_tpu_torch.ops import fir_cuda

    smi = chip_smoke.phase_device()
    libs, reports = build_variants(names)
    x, taps, base, sps, seg_len, off = chip_smoke._mf_args()
    C, n, _ = x.shape
    S, L = taps.shape[1:]
    want = fir_cuda.mf_segmented_plain(x, taps, base, sps, seg_len, off)
    rms = float(want.square().mean().sqrt())
    nbytes = (x.numel() + taps.numel() + base.numel() + want.numel()) * 4
    bound_ms = nbytes / chip_smoke.HBM_BPS * 1e3
    stream = torch.cuda.current_stream().cuda_stream
    calls, rec = {}, {}
    for name in names:
        plan = plan_for(name, C, S, seg_len, L, sps)
        lib = libs[name]
        assert lib.mf_segmented_smem_bytes(L, sps) == plan.smem_bytes, name
        y = torch.empty(want.shape, dtype=want.dtype, device=want.device)

        def call(lib=lib, plan=plan, y=y):
            err = lib.mf_segmented_launch(
                x.data_ptr(), taps.data_ptr(), base.data_ptr(), y.data_ptr(),
                C, n, S, seg_len, L, sps, off, plan.chunk, plan.n_chunks,
                None, 0, stream)
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
            return y

        got = call()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if "nofir" not in VARIANTS[name][3] \
                and not err <= chip_smoke.MF_TOL * rms:
            raise AssertionError(f"{name}: error {err}")
        calls[name] = call
        rec[name] = {"variant": name, "ptxas": reports[name],
                     "items": plan.items, "chunk": plan.chunk,
                     "smem_bytes": plan.smem_bytes,
                     "blocks_per_sm": lib.mf_segmented_grid_blocks(L, sps)
                     / torch.cuda.get_device_properties(0).multi_processor_count,
                     "max_abs_err": err, "ms": []}
    args6 = (x, taps, base, sps, seg_len, off)
    calls["wrapper"] = lambda: fir_cuda.mf_segmented(*args6)
    out = torch.empty(want.shape, dtype=want.dtype, device=want.device)
    calls["x.sum"] = lambda: x.sum()
    calls["y.copy_"] = lambda: out.copy_(want)
    for name in ("wrapper", "x.sum", "y.copy_"):
        rec[name] = {"variant": name, "ms": []}
    names = names + ["wrapper", "x.sum", "y.copy_"]
    times = time_in_turns({name: calls[name] for name in names},
                          args.rounds, 50)
    for name in names:
        rec[name]["ms"] = times[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fir_cuda.mf_segmented(*args6)
    rec["wrapper"]["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    sizes = {"x.sum": x.numel() * 4, "y.copy_": 2 * want.numel() * 4}
    for name in names:
        r = rec[name]
        best = min(r["ms"])
        moved = sizes.get(name, nbytes)
        r.update(best_ms=best, bound_ms=moved / chip_smoke.HBM_BPS * 1e3,
                 gbps=moved / best / 1e6)
        r["share"] = r["bound_ms"] / best
        print(json.dumps(r), flush=True)
    print(smi)
    print(json.dumps({name: [round(t, 5) for t in rec[name]["ms"]]
                      for name in names}))


if __name__ == "__main__":
    sys.exit(main())
