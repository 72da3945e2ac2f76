#!/usr/bin/env python3
"""Build variants of the BCH decoder's kernels side by side, read their
per-phase cycles and time them in turns.

    python3 tools/torch_bch_variants.py [--base ROOT] [--rounds 2]
        [--stamps-only] [NAME ...]

Variants (``VARIANTS``) are text-edited copies of two sources:

* ``base``: ``csrc/bch.cu`` of another checkout (``--base``, default
  ``build/ab/base``: unpack the first design there with ``git archive
  <rev> dvbs2rx_tpu_torch | tar -x -C build/ab/base``), whose
  Berlekamp-Massey kernel takes the syndromes of the decoder's matmul and
  whose Chien kernel takes (S, sigma, L);
* ``new``: this checkout's ``csrc/bch.cu``: the locator kernel (hard bits
  -> S, sigma, L) and the Chien kernel; ``new_bulk`` fills both kernels'
  tables by one TMA bulk copy on an mbarrier instead of cp.async.

A ``_stamps`` variant reads ``clock64()`` around each phase and adds the
cycles into a device array (``STAMPS_BASE``/``STAMPS_NEW`` name the
phases): per frame in Berlekamp-Massey (lane 0 of each warp); in the
locator per block for the syndrome stage and per last block of a frame
group (thread 0) for the tail; per searching block in Chien (thread 0, the
phases split by barriers; a stamped variant adds a barrier where a phase
had none). A phase's cycles are a mean over its units (slots 0-6, 16-22
and 32-38; slots 7, 23 and 39 hold the units' %globaltimer nanoseconds, so
cycles per nanosecond read the clock; the units are counted at slots 8, 24
and 40). Each stamp first adds 0 to the phase's last result, so the clock
is read once that result exists.

The inputs are ``chip_smoke.py`` phase 11's S2_B4, B = 128 error batch
(``_fec_tail_codewords`` with its seed, lane-major). Every variant is
held to the plain versions bit for bit (S, sigma, L, corrected bits,
n_corr), and each kernel's device time taken by the profiler
(``chip_smoke._profiled_device_ms``: an event timing of one small launch
is the host's enqueue rate). Then each round times every variant with
``chip_smoke._time_ms`` in order and in reverse
(``torch_variant_common.time_in_turns``): ``base`` as the syndrome matmul
+ its two kernels, ``new`` as its two kernels. Prints one JSON line per
variant, a summary line, and the card's name and power limit. Needs one
CUDA card.
"""

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

from torch_variant_common import (
    ROOT,
    apply_edits,
    build,
    read_stamps,
    stamps_prelude,
    time_in_turns,
)

PRELUDE = stamps_prelude("bch_stamps")
INCLUDE = "#include <stdint.h>\n"

# phases (slot: name); the count of stamped units sits at slot0 + 8
STAMPS_BASE = {
    0: "BM: syndrome load",
    1: "BM: 2t rounds",
    2: "BM: sigma and L writes",
    16: "Chien: S, sigma and log sigma reads (two barriers)",
    17: "Chien: antilog table fill (to an added barrier)",
    18: "Chien: set-up (64-bit exponents)",
    19: "Chien: search",
    20: "Chien: count and flip",
}
STAMPS_NEW = {
    0: "locator: staging to the first half's arrival",
    1: "locator: the two halves' sums (the second half landing meanwhile)",
    2: "locator: combine (block XOR, atomics, arrival)",
    32: "locator tail: sums back, Zech table copy started",
    33: "locator tail: S out and logs (global tables), Zech table waited",
    34: "locator tail: 2t rounds (8 lanes a frame, all 8 warps)",
    35: "locator tail: sigma and L writes",
    16: "Chien: reads and set-up, table copy in flight",
    17: "Chien: wait for the table",
    18: "Chien: search",
    19: "Chien: count and flip",
}

EDITS = {
    "stamps_base": [
        (INCLUDE, INCLUDE + PRELUDE),
        ("  if (frame >= B) return;                 // the whole warp leaves "
         "together\n",
         "  if (frame >= B) return;                 // the whole warp leaves "
         "together\n  STAMP_DECL\n"),
        ("(long long)frame * n_steps + lane] : 0;\n",
         "(long long)frame * n_steps + lane] : 0;\n  STAMP(0, s_mine);\n"),
        ("  if (lane <= t) sigma[(long long)frame * (t + 1) + lane] = C;\n",
         "  STAMP(1, C);\n"
         "  if (lane <= t) sigma[(long long)frame * (t + 1) + lane] = C;\n"),
        ("  if (lane == 0) L_out[frame] = L;\n}",
         "  if (lane == 0) L_out[frame] = L;\n  STAMP(2, L);\n"
         "  if (lane == 0) STAMPS_FLUSH(0);\n}"),
        ("  const int n_steps = 2 * t;\n  if (tid == 0) {",
         "  const int n_steps = 2 * t;\n  STAMP_DECL\n  if (tid == 0) {"),
        ("  const long long L = L_in[f];\n",
         "  STAMP(0, 0);\n  const long long L = L_in[f];\n"),
        ("i += kChienThreads) smem[i] = exp16[i];\n",
         "i += kChienThreads) smem[i] = exp16[i];\n"
         "  __syncthreads();\n  STAMP(1, 0);\n"),
        ("  __syncthreads();\n  for (int e = tid; e < nbch; "
         "e += kChienThreads) {",
         "  __syncthreads();\n  STAMP(2, 0);\n  for (int e = tid; e < nbch; "
         "e += kChienThreads) {"),
        ("  __syncthreads();\n  const int n_roots = s_count;",
         "  __syncthreads();\n  STAMP(3, 0);\n  const int n_roots = s_count;"),
        ("  if (tid == 0) n_corr[f] = ok ? n_roots : -1;\n}",
         "  if (tid == 0) n_corr[f] = ok ? n_roots : -1;\n  STAMP(4, 0);\n"
         "  if (tid == 0) STAMPS_FLUSH(16);\n}"),
    ],
    "stamps_new": [
        (INCLUDE, INCLUDE + PRELUDE),
        ("  const bool live = frame < B;\n",
         "  const bool live = frame < B;\n  STAMP_DECL\n"),
        ("    asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
         "    __syncthreads();\n",
         "    asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
         "    __syncthreads();\n    STAMP(0, 0);\n"),
        ("    sum_positions<KW>(s, bits_s, rows_s, half, np);\n"
         "    __syncthreads();\n",
         "    sum_positions<KW>(s, bits_s, rows_s, half, np);\n"
         "    STAMP(1, s[0] ^ s[KW - 1]);\n    __syncthreads();\n"),
        ("  if (!s_last) return;\n",
         "  STAMP(2, 0);\n  if (tid == 0) STAMPS_FLUSH(0);\n"
         "  if (!s_last) return;\n  STAMP_RESET;\n"),
        ("  const unsigned uord = (unsigned)ord;\n  // logs of S_1..S_2T",
         "  STAMP(0, 0);\n  const unsigned uord = (unsigned)ord;\n"
         "  // logs of S_1..S_2T"),
        ("  if (!dirty) return;\n",
         "  if (!dirty) return;\n  STAMP(1, 0);\n"),
        ("  const int frame_b = g * 32 + fr;\n",
         "  STAMP(2, L);\n  const int frame_b = g * 32 + fr;\n"),
        ("    if (r == 0) L_out[frame_b] = L;\n  }\n}",
         "    if (r == 0) L_out[frame_b] = L;\n  }\n  STAMP(3, 0);\n"
         "  if (tid == 0) STAMPS_FLUSH(32);\n}"),
        ("  const int n_steps = 2 * t;\n",
         "  const int n_steps = 2 * t;\n  STAMP_DECL\n"),
        ("  cp_async_wait_all();\n  __syncthreads();\n  for (int e = tid;",
         "  STAMP(0, xa[0] ^ xb[0]);\n  cp_async_wait_all();\n"
         "  __syncthreads();\n  STAMP(1, 0);\n  for (int e = tid;"),
        ("  __syncthreads();\n  const int n_roots = s_count;",
         "  __syncthreads();\n  STAMP(2, 0);\n  const int n_roots = s_count;"),
        ("  if (tid == 0) n_corr[f] = ok ? n_roots : -1;\n}",
         "  if (tid == 0) n_corr[f] = ok ? n_roots : -1;\n  STAMP(3, 0);\n"
         "  if (tid == 0) STAMPS_FLUSH(16);\n}"),
    ],
    # the Chien table by one bulk copy (TMA) on an mbarrier, not 16
    # cp.async of 16 bytes per thread
    "chien_bulk": [
        ("  __shared__ int s_count, s_nnz;\n",
         "  __shared__ int s_count, s_nnz;\n"
         "  __shared__ alignas(8) unsigned long long s_bar;\n"),
        ("#pragma unroll\n  for (int r = 0; r < kChienFill; ++r) {\n"
         "    const int i = tid + r * kChienThreads;\n"
         "    if (i < rows) cp_async16(smem + i, exp16 + i);\n  }\n",
         "  const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar);\n"
         "  if (tid == 0) {\n"
         "    asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\" "
         "::\"r\"(bar));\n"
         "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: "
         "\"memory\");\n"
         "    asm volatile(\"mbarrier.arrive.expect_tx.shared::cta.b64 _, "
         "[%0], %1;\" :: \"r\"(bar), \"r\"(rows * 16) : \"memory\");\n"
         "    for (int c = 0; c < rows; c += 2048) {\n"
         "      const unsigned d = (unsigned)__cvta_generic_to_shared("
         "smem + c);\n"
         "      asm volatile(\"cp.async.bulk.shared::cluster.global."
         "mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\" :: \"r\"(d), "
         "\"l\"(exp16 + c), \"r\"(min(2048, rows - c) * 16), \"r\"(bar) "
         ": \"memory\");\n"
         "    }\n  }\n"),
        ("  cp_async_wait_all();\n  __syncthreads();\n  for (int e = tid;",
         "  __syncthreads();\n  for (unsigned ready = 0; !ready;) {\n"
         "    asm volatile(\"{ .reg .pred P; mbarrier.try_wait.parity."
         "shared::cta.b64 P, [%1], 0; selp.u32 %0, 1, 0, P; }\" "
         ": \"=r\"(ready) : \"r\"(bar) : \"memory\");\n  }\n"
         "  for (int e = tid;"),
    ],
    # the locator tail's Zech table by one bulk copy (TMA) on an mbarrier
    "zech_bulk": [
        ("  __shared__ int s_last, s_dirty;\n",
         "  __shared__ int s_last, s_dirty;\n"
         "  __shared__ alignas(8) unsigned long long s_bar;\n"),
        ("  if (dirty) {\n    for (int i = tid; i < rows; i += kLocThreads)\n"
         "      cp_async16(smem + i, zech16 + i);\n  }\n",
         "  const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar);\n"
         "  if (dirty && tid == 0) {\n"
         "    asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\" "
         "::\"r\"(bar));\n"
         "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: "
         "\"memory\");\n"
         "    asm volatile(\"mbarrier.arrive.expect_tx.shared::cta.b64 _, "
         "[%0], %1;\" :: \"r\"(bar), \"r\"(rows * 16) : \"memory\");\n"
         "    for (int c = 0; c < rows; c += 2048) {\n"
         "      const unsigned d = (unsigned)__cvta_generic_to_shared("
         "smem + c);\n"
         "      asm volatile(\"cp.async.bulk.shared::cluster.global."
         "mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\" :: \"r\"(d), "
         "\"l\"(zech16 + c), \"r\"(min(2048, rows - c) * 16), \"r\"(bar) "
         ": \"memory\");\n"
         "    }\n  }\n"),
        ("  cp_async_wait_all();\n  __syncthreads();\n  if (!dirty) return;\n",
         "  __syncthreads();\n  if (!dirty) return;\n"
         "  for (unsigned ready = 0; !ready;) {\n"
         "    asm volatile(\"{ .reg .pred P; mbarrier.try_wait.parity."
         "shared::cta.b64 P, [%1], 0; selp.u32 %0, 1, 0, P; }\" "
         ": \"=r\"(ready) : \"r\"(bar) : \"memory\");\n  }\n"),
    ],
}
# name: (source, edits)
VARIANTS = {
    "base": ("base", ()),
    "base_stamps": ("base", ("stamps_base",)),
    "new": ("new", ()),
    "new_stamps": ("new", ("stamps_new",)),
    "new_bulk": ("new", ("zech_bulk", "chien_bulk")),
}
# profiler names of the parts' kernels
KERNELS = {"bm": "bch_berlekamp_massey_kernel",
           "locator": "bch_locator_kernel", "chien": "bch_chien_kernel"}
_P, _I = ctypes.c_void_p, ctypes.c_int
BASE_SIGNATURES = {
    "bch_berlekamp_massey_launch": [_P] * 5 + [_I] * 3 + [_P],
    "bch_chien_launch": [_P] * 6 + [_I] * 2 + [_P] + [_I] * 4 + [_P],
}


def variant_source(text, edits):
    for edit in edits:
        text = apply_edits(text, EDITS[edit])
    return text


def build_variants(names, base_root):
    from dvbs2rx_tpu_torch import _build

    srcs = {"new": (_build.SRC_DIR / "bch.cu").read_text()}
    if any(VARIANTS[n][0] == "base" for n in names):
        srcs["base"] = (Path(base_root) / "dvbs2rx_tpu_torch" / "csrc"
                        / "bch.cu").read_text()
    libs, logs = build(ROOT / "build" / "bch_variants",
                       {name: variant_source(srcs[VARIANTS[name][0]],
                                             VARIANTS[name][1])
                        for name in names})
    reports = {}
    for name, lib in libs.items():
        sigs = (BASE_SIGNATURES if VARIANTS[name][0] == "base"
                else {k: v for k, v in _build._SIGNATURES.items()
                      if k.startswith("bch_")})
        for fn, args in sigs.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        if "stamps" in name:
            lib.bch_stamps.argtypes = [_P]
            lib.bch_stamps.restype = _I
        reports[name] = {k: v for k, v in _build.ptxas_report(
            logs[name]).items() if "bch_" in k}
    return libs, reports


def inputs():
    """Phase 11's S2_B4, B = 128 error batch (lane-major), its decoder on
    the card, the field's tables, and the plain versions' outputs."""
    import numpy as np
    import torch

    import chip_smoke
    from dvbs2rx_tpu_torch.ops import bch
    from dvbs2rx_tpu_torch.ops.encode import get_device_encoder
    from dvbs2rx_tpu_torch.spec import bch_spec

    enc = get_device_encoder("normal", "1/2", "cuda")
    fec = enc.fec
    bits_t, _, n_err = chip_smoke._fec_tail_codewords(
        enc, 128, np.random.default_rng(2032))
    dec = bch.BCHDecoder("normal", fec.t, fec.nbch, fec.kbch, device="cuda")
    field = bch_spec.field_for("normal")
    ordn = field.order - 1
    e16 = np.zeros(-(-ordn // 8) * 8, np.uint16)
    e16[:ordn] = field.exp[:ordn]
    tab = {"exp": torch.as_tensor(field.exp.astype(np.int64)).cuda(),
           "log": torch.as_tensor(field.log.astype(np.int64)).cuda(),
           "exp16": torch.as_tensor(e16.view(np.int16)).cuda()}
    S, sig, L = bch.locator_plain(bits_t.t(), dec.syndrome_matrix(),
                                  tab["exp"], tab["log"], fec.t, ordn)
    want = bch.correct_plain(bits_t.t(), S, sig, L, dec.chien_matrix(),
                             fec.t)
    dec._T = None
    torch.cuda.empty_cache()
    return dec, bits_t, tab, (S, sig, L), want, n_err


def base_calls(lib, dec, bits_t, tab, S):
    """The first design on this batch: the syndrome matmul feeds its
    Berlekamp-Massey kernel, whose sigma and L feed its Chien kernel."""
    import torch

    B, t, nbch, ordn = bits_t.shape[1], dec.t, dec.nbch, dec.ord
    stream = torch.cuda.current_stream().cuda_stream
    bits = bits_t.t()

    def bm(S_):
        sigma = torch.empty((B, t + 1), dtype=torch.int64, device="cuda")
        L = torch.empty((B,), dtype=torch.int64, device="cuda")
        err = lib.bch_berlekamp_massey_launch(
            S_.data_ptr(), tab["exp"].data_ptr(), tab["log"].data_ptr(),
            sigma.data_ptr(), L.data_ptr(), B, t, ordn, stream)
        if err:
            raise RuntimeError(f"base BM: launch error {err}")
        return sigma, L

    def chien(S_, sigma, L):
        out = bits.clone()
        n_corr = torch.empty((B,), dtype=torch.int32, device="cuda")
        sb, se = out.stride()
        err = lib.bch_chien_launch(
            S_.data_ptr(), sigma.data_ptr(), L.data_ptr(),
            tab["exp16"].data_ptr(), tab["log"].data_ptr(), out.data_ptr(),
            sb, se, n_corr.data_ptr(), B, t, nbch, ordn, stream)
        if err:
            raise RuntimeError(f"base Chien: launch error {err}")
        return out, n_corr

    def decode():
        S_ = dec._syndromes(bits)
        sigma, L = bm(S_)
        return (S_, sigma, L), chien(S_, sigma, L)

    sigma, L = bm(S)
    return decode, {"bm": lambda: bm(S), "chien": lambda: chien(S, sigma, L)}


def new_calls(lib, dec, bits_t):
    """This checkout's two kernels, launched from the variant's library
    through the wrappers' launch functions, on their own scratch."""
    import torch
    from dvbs2rx_tpu_torch.ops import bch_cuda
    bits = bits_t.t()
    B, t, nbch, ordn = bits.shape[0], dec.t, dec.nbch, dec.ord
    _, chunks = bch_cuda.locator_plan(B, nbch, bch_cuda._n_sm(bits.device))
    scratch = bch_cuda.new_scratch(B, t, "cuda")

    def locator():
        S = torch.empty((B, 2 * t), dtype=torch.int64, device="cuda")
        sigma = torch.empty((B, t + 1), dtype=torch.int64, device="cuda")
        L = torch.empty((B,), dtype=torch.int64, device="cuda")
        bch_cuda._launch_locator(lib, bits, dec._odd, dec._exp16,
                                 dec._log16, dec._zech16, S, sigma, L,
                                 scratch, t, nbch, ordn, chunks)
        return S, sigma, L

    def chien(S, sigma, L):
        out = bits.clone()
        n_corr = torch.empty((B,), dtype=torch.int32, device="cuda")
        bch_cuda._launch_chien(lib, S, sigma, L, dec._exp16, dec._log, out,
                               n_corr, t, nbch, ordn)
        return out, n_corr

    def decode():
        loc = locator()
        return loc, chien(*loc)

    loc = locator()
    return decode, {"locator": locator, "chien": lambda: chien(*loc)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--base", default=str(ROOT / "build" / "ab" / "base"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--stamps-only", action="store_true",
                    help="check every variant and read the stamps; no timing")
    args = ap.parse_args()
    names = args.names or list(VARIANTS)

    import torch

    import chip_smoke

    smi = chip_smoke.phase_device()
    t0 = time.perf_counter()
    libs, reports = build_variants(names, args.base)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dec, bits_t, tab, (S, sig, L), want, n_err = inputs()
    calls, rec = {}, {}
    for name in names:
        lib = libs[name]
        if VARIANTS[name][0] == "base":
            decode, parts = base_calls(lib, dec, bits_t, tab, S)
        else:
            decode, parts = new_calls(lib, dec, bits_t)
        (S_k, sig_k, L_k), (out, n) = decode()
        torch.cuda.synchronize()
        for what, g, w in (("S", S_k, S), ("sigma", sig_k, sig),
                           ("L", L_k, L), ("bits", out, want[0]),
                           ("n_corr", n, want[1])):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{name}: {what} differs from the plain "
                                     f"version")
        r = {"variant": name, "bitwise_equal": True, "ptxas": reports[name],
             "ms": {}}
        if "stamps" in name:
            phases = STAMPS_BASE if VARIANTS[name][0] == "base" else STAMPS_NEW
            r["cycles_by_phase"] = read_stamps(lib.bch_stamps, decode,
                                                  phases)
        r["device_ms"] = {
            part: chip_smoke._profiled_device_ms(fn, KERNELS[part])
            for part, fn in parts.items()}
        rec[name] = r
        calls[name] = decode
        for part, fn in parts.items():
            calls[f"{name} {part}"] = fn
    if not args.stamps_only:
        for key, ms in time_in_turns(calls, args.rounds, 20).items():
            name, _, part = key.partition(" ")
            rec[name]["ms"][part or "decode"] = ms
    for r in rec.values():
        print(json.dumps(r), flush=True)
    print(smi)
    print(json.dumps({"n_err": n_err.tolist(), "ms": {
        n: {p: [round(t, 5) for t in v] for p, v in r["ms"].items()}
        for n, r in rec.items()}}))


if __name__ == "__main__":
    sys.exit(main())
