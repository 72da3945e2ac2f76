#!/usr/bin/env python3
"""Build variants of the VCM walk kernel side by side, hold each to the
plain composite, read their per-phase cycles and time them in turns.

    python3 tools/torch_walk_variants.py [--rounds 2] [--stamps-only]
        [NAME ...]

Variants (``EDITS``) are text-edited copies of this checkout's
``csrc/vcm_walk.cu``: ``new`` unedited; ``walk_only`` returns when the
walk ends, before the books (it writes only the frames walked, so it is
timed and not held); a ``_stamps`` variant reads ``clock64()`` at the
phases' ends (``new_stamps``: thread 0 of each block, ``STAMPS`` names the
phases, each including the wait at its closing barrier; ``slot_stamps``:
the parts of each walked slot, summed over a block's slots, in one thread
of each warp role, ``SLOT_STAMPS``; ``pro_stamps``: the prologue's parts,
``PRO_STAMPS``) and adds the cycles into a
device array (``torch_variant_common.stamps_prelude``): a phase's cycles
are a mean over the blocks, and slot 7 holds their %globaltimer
nanoseconds, so cycles per nanosecond read the clock.

The inputs are ``chip_smoke.py`` phase 6 (b)'s (``_walk_states``: 64
channels of piloted QPSK 1/2 and 8PSK 3/5 normal frames after 16 steps,
the default PLSC mode): the stream and the ring of dummy frames (every one
of the 21 slots alive, every estimate firing). Every variant but
``walk_only`` is held to ``_walk_books_plain`` on both
(``chip_smoke._books_diff``), its device time taken by the profiler
(``chip_smoke._profiled_device_ms``) on both, and each round times every
variant on the stream with ``chip_smoke._time_ms`` in order and in
reverse (``torch_variant_common.time_in_turns``). Prints one JSON line per
variant, a summary line, and the card's name and power limit. Needs one
CUDA card.
"""

import argparse
import json
import sys
import time

from torch_variant_common import (
    ROOT,
    apply_edits,
    bind,
    build,
    read_stamps,
    stamps_prelude,
    time_in_turns,
)

INCLUDE = "#include <stdint.h>\n"
PRELUDE = stamps_prelude("walk_stamps")
STAMPS = {
    0: "prologue: first windows, tables, candidate lengths (to the barrier)",
    1: "first frame: metric, shift",
    2: "walk: the walked slots, each to its barrier",
    3: "walk end: the last header; the walked headers' products with "
       "their PLHEADER rows",
    4: "books: warp 0's ballots (lanes, lock, metric sum); the "
       "autocorrelations (four groups of three warps)",
    5: "books: the lanes written",
    6: "books: the coarse recurrence (fires), the outputs",
}
STAMP_EDITS = [
    (INCLUDE, INCLUDE + PRELUDE),
    ("  const float2* ring = a.symbuf + (long long)c * n_sym;\n",
     "  const float2* ring = a.symbuf + (long long)c * n_sym;\n"
     "  STAMP_DECL\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n\n  // first frame",
     "  cp_async_wait_all();\n  __syncthreads();\n  STAMP(0, 0);\n\n"
     "  // first frame"),
    ("sm.rec[1][warp].x = __float_as_int(m);\n  }\n  __syncthreads();\n",
     "sm.rec[1][warp].x = __float_as_int(m);\n  }\n  __syncthreads();\n"
     "  STAMP(1, 0);\n"),
    ("    __syncthreads();\n    // slot k walked:",
     "    __syncthreads();\n    STAMP(2, 0);\n    // slot k walked:"),
    ("  __syncthreads();\n\n  // ---- books ----\n",
     "  __syncthreads();\n  STAMP(3, 0);\n\n  // ---- books ----\n"),
    ("t - 96 * g);\n  __syncthreads();\n  // the lanes\n",
     "t - 96 * g);\n  __syncthreads();\n  STAMP(4, 0);\n  // the lanes\n"),
    ("\n  // the coarse recurrence in slot order;",
     "\n  STAMP(5, 0);\n  // the coarse recurrence in slot order;"),
    ("    a.o_new_coarse[c] = new_coarse;\n  }\n}\n",
     "    a.o_new_coarse[c] = new_coarse;\n  }\n  STAMP(6, 0);\n"
     "  if (t == 0) STAMPS_FLUSH(0);\n}\n"),
]
# per walked slot, one thread of each role (metric warp 0: slots 0-5,
# decode warp 3: 16-, copy warp 6: 32-); cycles summed over a block's
# slots
SLOT_STAMPS = {
    0: "metric warp: the metric at its offset",
    1: "metric warp: the barrier",
    5: "metric warp: after the barrier, the selection to the next slot",
    16: "decode warp: its PLSC decode",
    17: "decode warp: the barrier",
    32: "copy warp: the header copied, the row and windows issued",
    34: "copy warp: the wait for its loads",
    33: "copy warp: the barrier",
}
SLOT_STAMP_EDITS = [
    (INCLUDE, INCLUDE + PRELUDE),
    ("  const float2* ring = a.symbuf + (long long)c * n_sym;\n",
     "  const float2* ring = a.symbuf + (long long)c * n_sym;\n"
     "  STAMP_DECL\n"),
    ("  int walked = 0;\n\n  for (int k = 0; k < K && alive; ++k) {\n",
     "  int walked = 0;\n  STAMP_RESET;\n\n"
     "  for (int k = 0; k < K && alive; ++k) {\n    STAMP(5, 0);\n"),
    ("      if (lane == 0) sm.rec[par][warp].x = __float_as_int(m);\n",
     "      if (lane == 0) sm.rec[par][warp].x = __float_as_int(m);\n"
     "      STAMP(0, __float_as_int(m));\n"),
    ("      if (lane == 0) sm.rec[par][o].y = d | (sm.info[d] << 7);\n",
     "      if (lane == 0) sm.rec[par][o].y = d | (sm.info[d] << 7);\n"
     "      STAMP(0, d);\n"),
    ("      cp_async_commit();\n      cp_async_wait_all();\n    }\n",
     "      cp_async_commit();\n      STAMP(0, 0);\n"
     "      cp_async_wait_all();\n      STAMP(2, 0);\n    }\n"),
    ("    __syncthreads();\n    // slot k walked:",
     "    __syncthreads();\n    STAMP(1, 0);\n    // slot k walked:"),
    ("  if (t == 0) {\n    sm.pos[walked] = pos;",
     "  if (t == 0) STAMPS_FLUSH(0);\n  if (t == 96) STAMPS_FLUSH(16);\n"
     "  if (t == 192) STAMPS_FLUSH(32);\n"
     "  if (t == 0) {\n    sm.pos[walked] = pos;"),
]
# the prologue's parts (thread 0)
PRO_STAMPS = {
    0: "the first windows issued, the float table and PLS tables loaded",
    1: "the PLS tables stored; the per-lane tables loaded",
    2: "the first barrier",
    3: "the distinct lengths: match, ballots, three barriers",
    4: "the candidate indices, the wait for the first windows, a barrier",
}
PRO_STAMP_EDITS = [
    (INCLUDE, INCLUDE + PRELUDE),
    ("  const float2* ring = a.symbuf + (long long)c * n_sym;\n",
     "  const float2* ring = a.symbuf + (long long)c * n_sym;\n"
     "  STAMP_DECL\n"),
    ("  const int tp = t & (kPls - 1);",
     "  STAMP(0, __float_as_int(sm.ft[t % kFTab].x));\n"
     "  const int tp = t & (kPls - 1);"),
    ("  // this lane's transform entries and scrambler bits",
     "  STAMP(1, 0);\n  // this lane's transform entries and scrambler bits"),
    ("  // the distinct frame lengths of the searched PLS: each warp's first",
     "  __syncthreads();\n  STAMP(2, pls4[3] + scr2);\n"
     "  // the distinct frame lengths of the searched PLS: each warp's first"),
    ("  int ci = -1;\n", "  STAMP(3, 0);\n  int ci = -1;\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n\n  // first frame",
     "  cp_async_wait_all();\n  __syncthreads();\n  STAMP(4, 0);\n"
     "  if (t == 0) STAMPS_FLUSH(0);\n\n  // first frame"),
]
WALK_ONLY = [("  // ---- books ----\n",
              "  if (t == 0) a.o_n_walked[c] = walked;\n  return;\n"
              "  // ---- books ----\n")]
EDITS = {
    "new": [],
    "new_stamps": STAMP_EDITS,
    "slot_stamps": SLOT_STAMP_EDITS,
    "pro_stamps": PRO_STAMP_EDITS,
    "walk_only": WALK_ONLY,
}
HELD = ("stream", "dummy")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--stamps-only", action="store_true")
    args = ap.parse_args()
    import chip_smoke
    from dvbs2rx_tpu_torch import _build, bench
    from dvbs2rx_tpu_torch.ops import vcm_walk_cuda
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
    from dvbs2rx_tpu_torch.spec.pls import make_pls

    names = args.names or [n for n in EDITS
                           if not args.stamps_only or "stamps" in n]
    src = (ROOT / "dvbs2rx_tpu_torch" / "csrc" / "vcm_walk.cu").read_text()
    t0 = time.perf_counter()
    libs, logs = build(ROOT / "build" / "walk_variants",
                       {n: apply_edits(src, EDITS[n]) for n in names})
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        bind(lib, _build._SIGNATURES, "vcm_walk_")
    cfg = RxConfig(modcod="qpsk1/2", frame_size="normal", acm_vcm=True,
                   pls_expected=(make_pls(4, False, True),
                                 make_pls(12, False, True)))
    sr = VCMStreamReceiver(cfg, chip_smoke.C, chip_smoke.F, device="cuda")
    iq, _, _ = chip_smoke._vcm_stimulus(sr)
    states = chip_smoke._walk_states(sr, iq)
    want = {case: sr._walk_books_plain(states[case]) for case in HELD}

    def call(lib, state):
        # the wrapper's launch with the variant's library
        real = _build.lib
        _build.lib = lambda: lib
        try:
            return sr._walk_books(state)
        finally:
            _build.lib = real

    calls, out = {}, {}
    for name in names:
        lib = libs[name]
        rec = {"ptxas": {k: v for k, v in _build.ptxas_report(
            logs[name]).items() if "vcm_walk" in k}}
        for case in HELD:
            state = states[case]
            fn = (lambda lb=lib, st=state: call(lb, st))
            if name != "walk_only":
                err, _, ties = chip_smoke._books_diff(sr, state, fn(),
                                                      want[case])
                rec[f"{case}_max_abs_err"] = max(err.values())
                rec[f"{case}_near_ties"] = ties
            rec[f"{case}_device_ms"] = chip_smoke._profiled_device_ms(
                fn, "vcm_walk_kernel")
            if "stamps" in name:
                rec[f"{case}_stamps"] = read_stamps(
                    lib.walk_stamps, fn,
                    {"slot_stamps": SLOT_STAMPS,
                     "pro_stamps": PRO_STAMPS}.get(name, STAMPS))
        calls[name] = (lambda lb=lib, st=states["stream"]: call(lb, st))
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)
    times = time_in_turns(calls, args.rounds, 20)
    print(json.dumps({"build_s": build_s, "stream_events_ms": times,
                      "device_ms": {n: {c: out[n][f"{c}_device_ms"]
                                        for c in HELD} for n in names},
                      "launches": vcm_walk_cuda.LAUNCHES}))
    print(bench.smi())


if __name__ == "__main__":
    sys.exit(main())
