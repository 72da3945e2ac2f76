#!/usr/bin/env python3
"""Build variants of the CRC-8 validity kernel side by side, read their
per-phase cycles and time them in turns.

    python3 tools/torch_crc8_variants.py [--base ROOT] [--rounds 2]
        [--stamps-only] [NAME ...]

Variants (``VARIANTS``) are text-edited copies of two sources:

* ``base``: ``csrc/crc8.cu`` of another checkout (``--base``, default
  ``build/ab/base``: unpack the first design there with ``git archive
  <rev> dvbs2rx_tpu_torch | tar -x -C build/ab/base``): one block a frame,
  each thread a run of 32 positions, its first window's CRC by W table
  steps, then slid; its tables are T and the outgoing byte's share;
* ``new``: this checkout's ``csrc/crc8.cu``, the scan of run CRCs;
  ``new_chain16`` computes each byte's prefix CRC by one chain of 16 T
  steps from the run's start, not from the P_g tables; ``new_rows``
  stages each row in shared memory by aligned 16-byte loads (byte loads
  out of it), instead of two 16-byte loads a thread into registers;
  ``new_sync_fill`` fills the tables through registers, not by cp.async
  (the design before its stamps); ``new_nolane`` drops the lane table C
  (8 KB), a lane's share of the warps before it from the A_k tables of
  its set bits.

A ``_stamps`` variant reads ``clock64()`` around each phase (thread 0 of
each block; ``STAMPS_BASE``/``STAMPS_NEW`` name the phases; the phases
after a barrier include the wait for the block's slowest warp) and adds
the cycles into a device array (``torch_variant_common.stamps_prelude``);
a phase's cycles are a mean over the blocks, and slot 7 holds their
%globaltimer nanoseconds, so cycles per nanosecond read the clock.

The inputs are ``chip_smoke.py`` phase 11's (``_crc_inputs`` with seed
2032): Tx BBFRAMEs of S2_B4, S2_B5 and short 1/2 and random rows of 879,
4,026, 4,836 and 7,274 bytes, B = 128. Every variant is held to
``packet_validity_plain`` bit for bit on each, its device time taken by
the profiler on the S2_B4 frames (``chip_smoke._profiled_device_ms``: an
event timing of one small launch is the host's enqueue rate) and each
round times every variant with ``chip_smoke._time_ms`` in order and in
reverse (``torch_variant_common.time_in_turns``). Prints one JSON line per
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

INCLUDE = "#include <stdint.h>\n"
PRELUDE = stamps_prelude("crc8_stamps")

# phases (slot: name); the count of stamped blocks sits at slot 8
STAMPS_BASE = {
    0: "load: row byte by byte into shared memory, tables (to the barrier)",
    1: "header flag (thread 0, serial)",
    2: "first window: W table steps",
    3: "slide: 32 positions",
    4: "write",
}
STAMPS_NEW = {
    0: "load: two 16-byte loads, the tables' fill (to the barrier)",
    1: "run CRC: slicing by 4",
    2: "scan: shuffles in each warp, the warp totals (a barrier), x",
    3: "prefix: P_g and the T chains",
    4: "window test: S stored, barrier, S read, Z",
    5: "write",
}

EDITS = {
    "stamps_base": [
        (INCLUDE, INCLUDE + PRELUDE),
        ("  const uint8_t* row = frames + (long long)f * n;\n",
         "  const uint8_t* row = frames + (long long)f * n;\n  STAMP_DECL\n"),
        ("  __syncthreads();\n  if (tid == 0) {",
         "  __syncthreads();\n  STAMP(0, 0);\n  if (tid == 0) {"),
        ("    hdr_ok[f] = rem == buf[slot(window + 9)];\n  }\n",
         "    hdr_ok[f] = rem == buf[slot(window + 9)];\n  }\n"
         "  STAMP(1, 0);\n"),
        ("  for (int k = 0; k < window; ++k) rem = T[rem ^ buf[slot(p0 + k)]];\n",
         "  for (int k = 0; k < window; ++k) rem = T[rem ^ buf[slot(p0 + k)]];\n"
         "  STAMP(2, rem);\n"),
        ("  uint8_t* dst = ok + (long long)f * n_packed + p0 / 8;\n",
         "  STAMP(3, bits);\n"
         "  uint8_t* dst = ok + (long long)f * n_packed + p0 / 8;\n"),
        ("    if (p0 / 8 + k < n_packed) dst[k] = (uint8_t)(bits >> (8 * k));\n"
         "  }\n}",
         "    if (p0 / 8 + k < n_packed) dst[k] = (uint8_t)(bits >> (8 * k));\n"
         "  }\n  STAMP(4, 0);\n  if (tid == 0) STAMPS_FLUSH(0);\n}"),
    ],
    "stamps_new": [
        (INCLUDE, INCLUDE + PRELUDE),
        ("  const int p0 = tid * kRun;\n",
         "  const int p0 = tid * kRun;\n  STAMP_DECL\n"),
        ("  __syncthreads();\n\n  // 2. run CRC",
         "  __syncthreads();\n  STAMP(0, 0);\n\n  // 2. run CRC"),
        ("  // 3. scan:", "  STAMP(1, L[3]);\n  // 3. scan:"),
        ("  // 4. prefix:", "  STAMP(2, x);\n  // 4. prefix:"),
        ("  // 5. window test:",
         "  STAMP(3, S[14] ^ S[15]);\n  // 5. window test:"),
        ("  // 6. write\n", "  STAMP(4, bits);\n  // 6. write\n"),
        ("  if (tid == 0) hdr_ok[f] = S[8] == byte_of(b, 9);\n}",
         "  if (tid == 0) hdr_ok[f] = S[8] == byte_of(b, 9);\n"
         "  STAMP(5, 0);\n  if (tid == 0) STAMPS_FLUSH(0);\n}"),
    ],
    # each byte's prefix by one chain of 16 T steps from x (no P_g reads)
    "chain16": [
        ("#pragma unroll\n  for (int g = 0; g < 4; ++g) S[4 * g + 3] = "
         "L[g] ^ tab[(kP + g) * 256 + x];\n", ""),
        ("    uint32_t prev = g ? S[4 * g - 1] : x;\n#pragma unroll\n"
         "    for (int m = 0; m < 3; ++m) {",
         "    uint32_t prev = g ? S[4 * g - 1] : x;\n#pragma unroll\n"
         "    for (int m = 0; m < 4; ++m) {"),
    ],
    # the tables' fill staged through registers (a load, then a store, per
    # 16 bytes), not by cp.async
    "fill_sync": [
        ("    cp_async16((uint4*)tab + i, (const uint4*)tables + i);\n",
         "    ((uint4*)tab)[i] = __ldg((const uint4*)tables + i);\n"),
        ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n", ""),
    ],
    # no lane table C: a lane's share of the warps before, M^(16 lane),
    # by the A_0..A_4 tables of the lane's set bits (5 dependent reads);
    # the fill stops before C (4.6 KB, not 12.5)
    "no_lane_table": [
        ("i < kTableBytes / 16;", "i < kC / 16;"),
        ("    if (warp > 0) x ^= tab[kC + before * 32 + lane];\n",
         "    if (warp > 0) {\n      uint32_t v = before;\n#pragma unroll\n"
         "      for (int k = 0; k < 5; ++k) {\n"
         "        const uint32_t a = tab[(kA + k) * 256 + v];\n"
         "        if ((lane >> k) & 1) v = a;\n      }\n      x ^= v;\n"
         "    }\n"),
    ],
    # the row staged in shared memory by aligned 16-byte loads, then each
    # thread's 16 bytes read from it one byte at a time
    "rows": [
        ("  __shared__ uint8_t warp_total[kMaxThreads / 32];\n",
         "  __shared__ uint8_t warp_total[kMaxThreads / 32];\n"
         "  __shared__ __align__(16) uint8_t s_row[kMaxN + 32];\n"),
        ("  uint32_t b[4] = {0u, 0u, 0u, 0u};\n  if (p0 < n) {",
         "  uint32_t b[4] = {0u, 0u, 0u, 0u};\n"
         "  const uint8_t* row0 = frames + (long long)f * n;\n"
         "  const uintptr_t r0 = (uintptr_t)row0 & ~(uintptr_t)15;\n"
         "  const int rsh = (int)((uintptr_t)row0 & 15);\n"
         "  for (int i = tid; i * 16 < rsh + n; i += blockDim.x)\n"
         "    ((uint4*)s_row)[i] = __ldg((const uint4*)(r0 + 16 * i));\n"
         "  __syncthreads();\n"
         "  if (p0 < n) {\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < kRun; ++j)\n"
         "      b[j >> 2] |= (p0 + j < n ? (uint32_t)s_row[rsh + p0 + j] : 0u)"
         " << (8 * (j & 3));\n"
         "  }\n  if (false) {"),
    ],
}
# name: (source, edits)
VARIANTS = {
    "base": ("base", ()),
    "base_stamps": ("base", ("stamps_base",)),
    "new": ("new", ()),
    "new_stamps": ("new", ("stamps_new",)),
    "new_chain16": ("new", ("chain16",)),
    "new_rows": ("new", ("rows",)),
    "new_sync_fill": ("new", ("fill_sync",)),
    "new_sync_fill_stamps": ("new", ("fill_sync", "stamps_new")),
    "new_nolane": ("new", ("no_lane_table",)),
    "new_nolane_stamps": ("new", ("no_lane_table", "stamps_new")),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_source(text, edits):
    for edit in edits:
        text = apply_edits(text, EDITS[edit])
    return text


def build_variants(names, base_root):
    from dvbs2rx_tpu_torch import _build

    srcs = {"new": (_build.SRC_DIR / "crc8.cu").read_text()}
    if any(VARIANTS[n][0] == "base" for n in names):
        srcs["base"] = (Path(base_root) / "dvbs2rx_tpu_torch" / "csrc"
                        / "crc8.cu").read_text()
    libs, logs = build(ROOT / "build" / "crc8_variants",
                       {name: variant_source(srcs[VARIANTS[name][0]],
                                             VARIANTS[name][1])
                        for name in names})
    reports = {}
    for name, lib in libs.items():
        lib.crc8_validity_launch.argtypes = _build._SIGNATURES[
            "crc8_validity_launch"]
        lib.crc8_validity_launch.restype = _I
        if "stamps" in name:
            lib.crc8_stamps.argtypes = [_P]
            lib.crc8_stamps.restype = _I
        reports[name] = {k: v for k, v in _build.ptxas_report(
            logs[name]).items() if "crc8" in k}
    return libs, reports


def base_tables(window):
    """The first design's tables: T, then the CRC of a byte followed by
    ``window`` zero bytes."""
    import numpy as np

    from dvbs2rx_tpu_torch.ops import crc8_cuda
    from dvbs2rx_tpu_torch.spec.scramblers import crc8_table

    T = crc8_table()
    return np.concatenate([T, crc8_cuda.power(window)[T]])


def validity_call(lib, tables, frames, window=187):
    """fn() launching the variant's kernel on ``frames`` (B, n) uint8."""
    import torch

    B, n = frames.shape
    ok = torch.empty((B, -(-n // 8)), dtype=torch.uint8, device="cuda")
    hdr = torch.empty((B,), dtype=torch.int32, device="cuda")

    def fn():
        err = lib.crc8_validity_launch(
            frames.data_ptr(), tables.data_ptr(), ok.data_ptr(),
            hdr.data_ptr(), B, n, ok.shape[1], window,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"crc8 variant: launch error {err}")
        return ok, hdr
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--base", default=str(ROOT / "build" / "ab" / "base"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--stamps-only", action="store_true",
                    help="check every variant and read the stamps; no timing")
    args = ap.parse_args()
    names = args.names or list(VARIANTS)

    import numpy as np
    import torch

    import chip_smoke
    from dvbs2rx_tpu_torch.ops import crc8_cuda, crc8_dev

    smi = chip_smoke.phase_device()
    t0 = time.perf_counter()
    libs, reports = build_variants(names, args.base)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    inputs = chip_smoke._crc_inputs(np.random.default_rng(2032))
    tabs = {"base": torch.as_tensor(base_tables(187), device="cuda"),
            "new": torch.as_tensor(crc8_cuda.tables(187), device="cuda")}
    main_input = inputs["tx_qpsk1/2_normal"]
    calls, rec = {}, {}
    for name in names:
        lib, tab = libs[name], tabs[VARIANTS[name][0]]
        for key, frames in inputs.items():
            got = validity_call(lib, tab, frames)()
            want = crc8_dev.packet_validity_plain(frames)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"{name}: {key} differs from the "
                                         f"plain version")
        fn = validity_call(lib, tab, main_input)
        r = {"variant": name, "bitwise_equal": list(inputs),
             "ptxas": reports[name], "ms": []}
        if "stamps" in name:
            phases = STAMPS_BASE if VARIANTS[name][0] == "base" else STAMPS_NEW
            r["cycles_by_phase"] = read_stamps(lib.crc8_stamps, fn, phases)
        r["device_ms"] = chip_smoke._profiled_device_ms(
            fn, "crc8_validity_kernel")
        rec[name] = r
        calls[name] = fn
    if not args.stamps_only:
        for name, ms in time_in_turns(calls, args.rounds, 20).items():
            rec[name]["ms"] = ms
    for r in rec.values():
        print(json.dumps(r), flush=True)
    print(smi)
    print(json.dumps({"shape": list(main_input.shape), "variants": {
        n: {"device_ms": round(r["device_ms"], 5),
            "ms": [round(t, 5) for t in r["ms"]]} for n, r in rec.items()}}))


if __name__ == "__main__":
    sys.exit(main())
