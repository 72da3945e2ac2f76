#!/usr/bin/env python3
"""Build variants of the Gardner kernel side by side and time them in turns.

    python3 tools/torch_gardner_variants.py [--base ROOT] [--rounds 2]
        [--stamps-only] [NAME ...]

Variants (``VARIANTS``) are text-edited copies of two sources:

* ``base``: ``csrc/gardner.cu`` of another checkout (``--base``, default
  ``build/ab/base``: unpack the first design there with ``git archive
  <rev> dvbs2rx_tpu_torch | tar -x -C build/ab/base``), launched through
  its own entry point (one walking thread, no candidate slots);
* ``new``: this checkout's ``csrc/gardner.cu`` at the variant's
  ``kThreads``, launched with a plan the tool computes from the variant's
  own ``gardner_smem_bytes`` (its header, candidate slots and taps), as
  ``gardner_cuda.launch_plan`` does for the package's kernel.

A ``_stamps`` variant reads ``clock64()`` around each phase of a symbol and
adds the cycles per phase into a device array (the walker's lane 0; in the
new kernel also the first helper thread): ``STAMPS_BASE``/``STAMPS_NEW``
name the phases. Each stamp first adds 0 to the phase's last result, so
the clock is read once that result exists. The base's stamp variant adds a
load-only pass (the same shared loads, XOR-folded) before the dot
products to time the loads alone; that pass is extra work of the stamped
kernel only.

All variants build in parallel with the package's nvcc flags into
``build/gardner_variants/`` (``torch_variant_common.build``) and run on
``chip_smoke.py``'s phase-8 inputs (``_gardner_inputs``). Every variant is
held to ``symbol_sync_plain`` bit for bit (integers and floats equal) on
every case. Then each round times every case of every variant with
``chip_smoke._time_ms`` (20 timings of 10 back-to-back launches), in order
and then in reverse (``torch_variant_common.time_in_turns``). Prints
one JSON line per variant and case (ptxas registers, times, cycles per
symbol at chip_smoke's SM clock, speculation hits and misses, per-phase
cycles of a stamp variant) and a summary line. Needs one CUDA card.
"""

import argparse
import ctypes
import json
import re
import sys
import time
from pathlib import Path

from torch_variant_common import ROOT, apply_edits, build, time_in_turns

# cases: (name, interpolator, sps, channels, symbols), chip_smoke's shapes
CASES = (
    ("p2_c1", "polyphase", 2, 1, 4096),
    ("p4_c1", "polyphase", 4, 1, 4096),
    ("p2_c8", "polyphase", 2, 8, 4096),
    ("p4_c8", "polyphase", 4, 8, 4096),
    ("linear", "linear", 2, 1, 1024),
    ("quadratic", "quadratic", 2, 1, 1024),
    ("cubic", "cubic", 2, 1, 1024),
)
STAMPED_CASES = ("p2_c1", "p4_c1")

# The stamp prelude: a device array of cycle sums, a clock read that waits
# for one value, and the host's read-and-clear.
PRELUDE = r'''
__device__ unsigned long long g_stamps[32];
__device__ __forceinline__ long long stamp_now(float dep) {
  float sink;
  long long t;
  asm volatile("add.f32 %0, %1, 0f00000000;" : "=f"(sink) : "f"(dep));
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
#define STAMP(slot, dep) do { const long long _t = stamp_now(dep); \
  acc[slot] += _t - t_last; t_last = _t; } while (0)
#define STAMP_DECL long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long t_last = clock64(); int nsym = 0;
__device__ __forceinline__ void stamps_flush(const long long* acc, int nsym,
                                             int slot0) {
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    for (int j = 0; j < 8; ++j)
      atomicAdd(&g_stamps[slot0 + j], (unsigned long long)acc[j]);
    atomicAdd(&g_stamps[slot0 + 8], (unsigned long long)nsym);
  }
}
extern "C" int gardner_stamps(void* out) {
  static const unsigned long long zero[32] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
  return (int)e;
}
'''
INCLUDE = "#include <cuda_runtime.h>\n"

# phases of one symbol (slot: name); the walker's lane 0 at slots 0-7,
# the new kernel's first helper thread at 16-23
STAMPS_BASE = {
    0: "strobe and index arithmetic, subfilter floor/convert/clamp, loop",
    1: "loads alone (load-only pass, extra)",
    2: "dot products (loads and FMAs as compiled)",
    3: "error term and PI loop (to lag)",
    4: "first divide (lag / W2)",
    5: "floor, conversions and the basepoint FMA",
    6: "second divide (and its branch)",
    7: "clip and state",
}
STAMPS_NEW = {
    0: "strobe and index arithmetic, slot index, hand-off store",
    1: "hand-off barrier wait",
    2: "pair: slot load on a hit, dot products on a miss",
    3: "error term, PI loop, reciprocals (to lag)",
    4: "first quotient and its floor",
    5: "basepoint (2 - jump in floats, FMA)",
    6: "second quotient (operands by select)",
    7: "clip, next strobe, subfilter and slot index",
    16: "helper: hand-off barrier wait",
    17: "helper: hand-off read, candidate index, window clamp",
    18: "helper: dot products and slot store",
}

EDITS = {
    "stamps_base": [
        (INCLUDE, INCLUDE + PRELUDE),
        ("  const int hi_start = p.n - p.W;\n  for (; s.k < p.n_out; ++s.k) {",
         "  const int hi_start = p.n - p.W;\n  STAMP_DECL\n"
         "  for (; s.k < p.n_out; ++s.k) {"),
        ("      need = lo;\n      return false;",
         "      need = lo;\n      stamps_flush(acc, nsym, 0);\n"
         "      return false;"),
        ("      isub = clampi(isub, 0, p.n_subfilt - 1);\n"
         "      dot2(a, b, tab + isub * p.W, p.W, o, z);",
         "      isub = clampi(isub, 0, p.n_subfilt - 1);\n"
         "      STAMP(0, __int_as_float(isub));\n"
         "      {\n        const float* t = tab + isub * p.W;\n"
         "        unsigned x0 = 0, x1 = 0, x2 = 0, x3 = 0;\n"
         "        for (int l = 0; l < p.W; ++l) {\n"
         "          x0 ^= __float_as_uint(t[l]);\n"
         "          x1 ^= __float_as_uint(a[l].x) ^ __float_as_uint(a[l].y);\n"
         "          x2 ^= __float_as_uint(b[l].x);\n"
         "          x3 ^= __float_as_uint(b[l].y);\n        }\n"
         "        const unsigned xx = x0 ^ x1 ^ x2 ^ x3;\n"
         "        STAMP(1, __uint_as_float(xx));\n"
         "        if (xx == 0x7fc00001u && p.n < 0) g_stamps[31] = 1;\n"
         "      }\n"
         "      dot2(a, b, tab + isub * p.W, p.W, o, z);\n"
         "      STAMP(2, z.y);"),
        ("    const float lag = __fsub_rn(s.cnt, W1);\n"
         "    const int jump = (int)__fadd_rn(floorf(__fdiv_rn(lag, W2)), 2.f);",
         "    const float lag = __fsub_rn(s.cnt, W1);\n    STAMP(3, lag);\n"
         "    const float q1 = __fdiv_rn(lag, W2);\n    STAMP(4, q1);\n"
         "    const int jump = (int)__fadd_rn(floorf(q1), 2.f);"),
        ("    const float basep = __fmaf_rn((float)(2 - jump), W2, lag);\n"
         "    float mu, cnt;",
         "    const float basep = __fmaf_rn((float)(2 - jump), W2, lag);\n"
         "    STAMP(5, basep);\n    float mu, cnt;"),
        ("    if (mu < 0.f) mu = 0.f;              // torch.clamp",
         "    STAMP(6, mu);\n    if (mu < 0.f) mu = 0.f;              "
         "// torch.clamp"),
        ("    s.l0 = o.x;\n    s.l1 = o.y;\n  }\n  return true;",
         "    s.l0 = o.x;\n    s.l1 = o.y;\n    STAMP(7, s.mu);\n    ++nsym;\n"
         "  }\n  stamps_flush(acc, nsym, 0);\n  return true;"),
    ],
    "stamps_new": [
        (INCLUDE, INCLUDE + PRELUDE),
        ("__device__ __forceinline__ float update(Loop& s, const Params& p, "
         "float2 o,\n                                        float2 z) {",
         "__device__ __forceinline__ float update(Loop& s, const Params& p, "
         "float2 o,\n                                        float2 z, "
         "long long* acc, long long& t_last) {"),
        ("  const float lag = __fsub_rn(s.cnt, W1);\n  const float f2 =",
         "  const float lag = __fsub_rn(s.cnt, W1);\n  STAMP(3, lag);\n"
         "  const float f2 ="),
        ("  const float f2 = __fadd_rn(floorf(div_fast(lag, W2, r2)), 2.f);\n",
         "  const float f2 = __fadd_rn(floorf(div_fast(lag, W2, r2)), 2.f);\n"
         "  STAMP(4, f2);\n"),
        ("  const float basep = __fmaf_rn(__fsub_rn(2.f, f2), W2, lag);\n",
         "  const float basep = __fmaf_rn(__fsub_rn(2.f, f2), W2, lag);\n"
         "  STAMP(5, basep);\n"),
        ("  const float mu = div_fast(num, den, single ? r1 : r2);\n",
         "  const float mu = div_fast(num, den, single ? r1 : r2);\n"
         "  STAMP(6, mu);\n"),
        ("  int i = -1;                    // slot of the strobe's "
         "(jump, isub)\n",
         "  int i = -1;                    // slot of the strobe's "
         "(jump, isub)\n  STAMP_DECL\n"),
        ("      if (lane0) head->hand[r & 1] = make_int4(pos, isub, stop, 0);\n"
         "      hand_off();\n",
         "      if (lane0) head->hand[r & 1] = make_int4(pos, isub, stop, 0);\n"
         "      STAMP(0, __int_as_float(w.lo + i));\n      hand_off();\n"
         "      STAMP(1, 0.f);\n"),
        ("      need = w.lo;\n      return end;",
         "      need = w.lo;\n      stamps_flush(acc, nsym, 0);\n"
         "      return end;"),
        ("        misses += r > 0;\n      }\n",
         "        misses += r > 0;\n      }\n      STAMP(2, z.y);\n"),
        ("    const float raw = update(s, q, o, z);\n",
         "    const float raw = update(s, q, o, z, acc, t_last);\n"),
        ("      isub = next;\n    }\n  }\n}",
         "      isub = next;\n    }\n"
         "    STAMP(7, __int_as_float(isub + i + __float_as_int(s.mu)));\n"
         "    ++nsym;\n  }\n}"),
        ("  for (int r = 0;; ++r) {\n"
         "    hand_off();\n    const int4 h = head->hand[r & 1];\n"
         "    if (h.z) return;\n",
         "  STAMP_DECL\n"
         "  for (int r = 0;; ++r) {\n    hand_off();\n    STAMP(0, 0.f);\n"
         "    const int4 h = head->hand[r & 1];\n"
         "    if (h.z) {\n      stamps_flush(acc, nsym, 16);\n      return;\n"
         "    }\n"),
        ("    if (live && lo >= base && hi <= end_tile) {\n      slot[",
         "    STAMP(1, __int_as_float(lo + hi + t));\n"
         "    if (live && lo >= base && hi <= end_tile) {\n      slot["),
        ("                                                  tab + t * W, W);\n"
         "    }\n",
         "                                                  tab + t * W, W);\n"
         "    }\n    STAMP(2, 0.f);\n    ++nsym;\n"),
    ],
    # every symbol through update_exact (the JAX body's divides as written)
    "exact": [("  return ((__float_as_uint(v) >> 23) & 0xff) - 95u <= 64u;",
               "  return v != v;")],
}
# the first design's entry point: 15 pointers, 10 ints (C, n, n_out,
# interp, W, lead, mid, n_subfilt, table_floats, tile), 4 floats, stream
BASE_SIGNATURE = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
                  + [ctypes.c_float] * 4 + [ctypes.c_void_p])
# name: (source, kThreads or None, edits); "base" and "new" are the sources
# as they stand
VARIANTS = {
    "base": ("base", None, ()),
    "base_stamps": ("base", None, ("stamps_base",)),
    "new": ("new", 128, ()),
    "new_stamps": ("new", 128, ("stamps_new",)),
    "new_t96": ("new", 96, ()),
    "new_t256": ("new", 256, ()),
    "new_exact": ("new", 128, ("exact",)),
}


def variant_source(text, threads, edits):
    if threads is not None:
        text, k = re.subn(r"constexpr int kThreads = \d+;",
                          f"constexpr int kThreads = {threads};", text)
        assert k == 1
    for edit in edits:
        text = apply_edits(text, EDITS[edit])
    return text


def build_variants(names, base_root):
    from dvbs2rx_tpu_torch import _build

    srcs = {"new": (_build.SRC_DIR / "gardner.cu").read_text()}
    if any(VARIANTS[n][0] == "base" for n in names):
        srcs["base"] = (Path(base_root) / "dvbs2rx_tpu_torch" / "csrc"
                        / "gardner.cu").read_text()
    libs, logs = build(ROOT / "build" / "gardner_variants",
                       {name: variant_source(srcs[VARIANTS[name][0]],
                                             *VARIANTS[name][1:])
                        for name in names})
    P, I = ctypes.c_void_p, ctypes.c_int
    reports = {}
    for name, lib in libs.items():
        if VARIANTS[name][0] == "base":
            lib.gardner_launch.argtypes = BASE_SIGNATURE
        else:
            lib.gardner_launch.argtypes = _build._SIGNATURES["gardner_launch"]
            lib.gardner_smem_bytes.argtypes = [I, I]
            lib.gardner_smem_bytes.restype = I
        lib.gardner_launch.restype = I
        if "stamps" in name:
            lib.gardner_stamps.argtypes = [P]
            lib.gardner_stamps.restype = I
        reports[name] = {k.split("gardner_kernel")[1][:12]: v
                         for k, v in _build.ptxas_report(logs[name]).items()
                         if "gardner_kernel" in k}
    return libs, reports


def make_call(name, lib, sync, st, x, n_out, counts):
    """A closure that launches variant ``name`` on (sync, st, x, n_out) and
    returns (state', symbols) like ``gardner_cuda.symbol_sync``."""
    import torch
    from dvbs2rx_tpu_torch.ops import gardner_cuda as G
    from dvbs2rx_tpu_torch.utils.runtime import device_table

    src, threads, _ = VARIANTS[name]
    stream = torch.cuda.current_stream().cuda_stream if x.is_cuda else 0
    C, n, _ = x.shape
    table, W, lead = G.window(sync)
    tf = 0 if table is None else table.size
    if src == "new":
        # the variant's own header, slots and taps; the rest is the tile
        fixed = lib.gardner_smem_bytes(tf, 0)
        tile = min(n, (G.SMEM_LIMIT - fixed) // 8)
        plan = G.GardnerPlan(tf, tile, (threads - G.WALKERS) // 2,
                             fixed + 8 * tile)
        return lambda: G._launch(lib, sync, st, x, n_out, counts, stream,
                                 plan)
    # the base's entry point: no counters, no candidate plan
    tab = None if table is None else device_table(table, x.device)
    tile = min(n, (G.SMEM_LIMIT - -(-tf * 4 // 16) * 16) // 8)
    f32, i32 = torch.float32, torch.int32
    ins = [st.cnt.to(f32).contiguous(), st.mu.to(f32).contiguous(),
           st.vi.to(f32).contiguous(), st.jump.to(i32).contiguous(),
           st.n.to(i32).contiguous(), st.last_xi.to(f32).contiguous()]
    outs = [torch.empty_like(t) for t in ins]
    sym = torch.empty((C, n_out, 2), dtype=f32, device=x.device)
    args = [x.data_ptr(), 0 if tab is None else tab.data_ptr(),
            sym.data_ptr(), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in outs), C, n, n_out, sync.interp, W, lead,
            sync.midpoint, sync.n_subfilt, tf, tile, sync.K1, sync.K2,
            sync.nominal, sync.mu_max, stream]

    def call():
        err = lib.gardner_launch(*args)
        if err:
            raise RuntimeError(f"{name}: launch error {err}")
        cnt, mu, vi, jump, pos, last = outs
        return G.SymbolSyncState(cnt, mu, vi, jump, last, pos), sym

    return call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--base", default=str(ROOT / "build" / "ab" / "base"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--stamps-only", action="store_true",
                    help="check every variant and read the stamps; no timing")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    args = ap.parse_args()
    names = args.names or list(VARIANTS)
    cases = [c for c in CASES if c[0] in args.cases.split(",")]

    import torch

    import chip_smoke
    from dvbs2rx_tpu_torch.ops import gardner_cuda as G

    smi = chip_smoke.phase_device()
    t0 = time.perf_counter()
    libs, reports = build_variants(names, args.base)
    print(f"built {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in names:
        print(json.dumps({"variant": name, "ptxas": reports[name]}))
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    calls, rec = {}, {}
    for case, interp, sps, C, n_out in cases:
        sync, x, st = chip_smoke._gardner_inputs(interp, sps, C, n_out)
        t1 = time.perf_counter()
        want_st, want = G.symbol_sync_plain(sync, st, x, n_out)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        for name in names:
            if VARIANTS[name][0] == "new" and interp != "polyphase" \
                    and VARIANTS[name][1] != 128:
                continue        # the helper count touches polyphase only
            call = make_call(name, libs[name], sync, st, x, n_out, counts)
            counts.zero_()
            got_st, got = call()
            torch.cuda.synchronize()
            hits, misses = counts.tolist()
            for k in ("cnt", "mu", "vi", "jump", "last_xi", "n"):
                if not torch.equal(getattr(got_st, k), getattr(want_st, k)):
                    raise AssertionError(f"{name} {case}: {k} differs")
            if not torch.equal(got, want):
                err = float((got - want).abs().max())
                raise AssertionError(f"{name} {case}: symbols differ {err}")
            r = {"variant": name, "case": case, "bitwise_equal": True,
                 "plain_s": plain_s, "ms": []}
            if VARIANTS[name][0] == "new" and interp == "polyphase":
                r.update(hits=hits, misses=misses)
            if "stamps" in name and case in STAMPED_CASES:
                buf = (ctypes.c_ulonglong * 32)()
                libs[name].gardner_stamps(buf)     # clear
                call()
                torch.cuda.synchronize()
                if libs[name].gardner_stamps(buf):
                    raise RuntimeError(f"{name}: reading the stamps failed")
                phases = STAMPS_BASE if name.startswith("base") else STAMPS_NEW
                per = {}
                for slot, what in phases.items():
                    nsym = buf[(slot // 16) * 16 + 8]
                    per[what] = buf[slot] / max(nsym, 1)
                r["cycles_per_symbol_by_phase"] = per
                r["walker_cycles_per_symbol"] = sum(
                    v for s_, v in zip(phases, per.values()) if s_ < 16)
            calls[(name, case)] = call
            rec[(name, case)] = r
    if not args.stamps_only:
        for key, ms in time_in_turns(calls, args.rounds, 20).items():
            rec[key]["ms"] = ms
    for (name, case), r in rec.items():
        n_out = next(c[4] for c in CASES if c[0] == case)
        if r["ms"]:
            best = min(r["ms"])
            r.update(best_ms=best, cycles_per_symbol=best * 1e-3
                     * chip_smoke.SM_CLOCK_HZ / n_out)
        print(json.dumps(r), flush=True)
    print(smi)
    print(json.dumps({f"{n} {c}": [round(t, 5) for t in r["ms"]]
                      for (n, c), r in rec.items()}))


if __name__ == "__main__":
    sys.exit(main())
