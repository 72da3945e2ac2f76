#!/usr/bin/env python3
"""Build the O&M tracker kernel of two checkouts side by side, with and
without phase stamps, hold each to the plain tracker, compare their
outputs bit for bit and read their per-phase cycles.

    python3 tools/torch_ffsync_variants.py [--base build/ab/parent]
        [--rounds 1] [--stamps-only] [NAME ...]

Variants (``EDITS``) are text-edited copies of ``csrc/ffsync.cu``:
``base`` and ``base_stamps`` of the ``--base`` checkout (unpack one with
``git archive <rev> dvbs2rx_tpu_torch | tar -x -C build/ab/parent``; by
default the one-block-a-channel design), and of this checkout ``new``,
``new_stamps``, ``new_g4`` (clusters of 4 blocks of 4 pieces, 512
threads), ``new_g6`` (6 blocks of 3 pieces at <= 40 registers: a
64-channel launch is resident at once) and ``_waves`` variants (the
first and last block's start and end by %globaltimer, and how many
clusters of the launch can be resident at once,
cudaOccupancyMaxActiveClusters). A ``_stamps`` variant reads
``clock64()`` at the ends of its phases in thread 0 of a channel's block
(``BASE_STAMPS``: the first staging round's loads to their barrier and
its sums, the other three rounds' the same, the barrier after the last
round, warp 0's window combine and atan2s, lane 0's chain, the segments
and the gather; ``NEW_STAMPS``: the piece's loads issued, the wait for
them, the sums, the partials written into rank 0, then on rank 0 the
bank's copies issued, the end barrier, the combine and atan2s, lane 0's
chain, the segments, the bank's wait and the barrier, the gather; ``rank
1``: the first four on a second block of the cluster) and adds the cycles
into a device array (``torch_variant_common.stamps_prelude``): a phase's
cycles are a mean over the channels, and each group's %globaltimer
nanoseconds give cycles per nanosecond.

Cases (``CASES``, seeded noisy QPSK at 2 samples a symbol, tracker state
initialised on some channels): ``ccm``, the CCM stream step's layout (64
channels read in place from a 196,010-row buffer at starts that clamp at
both ends, 64,980 symbols: 16 windows); ``host``, a host receiver's
4,096-symbol block at C = 1 (one window of 8,295 samples, 9 pieces);
``host16k``, one window of 16,383 samples (16 pieces) at C = 1; ``c8``,
the same at C = 8. Each checkout's variants run in a process of their own
(the wrapper's ``_launch`` with the variant's library; the two designs
take different arguments), every variant's outputs (tau, rate,
initialized, taps, offsets, consumed) are hashed per case
(``track_digest``) and held to ``_track_plain`` (``chip_smoke.
_track_case``: equal off the bin edges, tau and drift within TRACK_TOL);
the profiler's device time per case; each round runs the checkouts in
order and in reverse. Prints one JSON line per variant, a summary line
(``same_outputs``: every variant of both checkouts gives each case's
bytes), and the card's name and power limit. Needs one CUDA card.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

from torch_variant_common import (
    ROOT,
    apply_edits,
    bind,
    build,
    read_stamps,
    stamps_prelude,
)

INCLUDE = "#include <stdint.h>\n"
PRELUDE = stamps_prelude("ffsync_stamps")

BASE_STAMPS = {
    0: "round 1: the piece's loads to the barrier",
    1: "round 1: the sums",
    2: "rounds 2-4: the loads to the barrier",
    3: "rounds 2-4: the sums",
    4: "the barrier after the last round",
    16: "warp 0: the window combine and atan2s",
    17: "lane 0: the chain to its writes",
    18: "the segments and the barrier",
    19: "the taps gather",
}
BASE_STAMP_EDITS = [
    (INCLUDE, INCLUDE + PRELUDE),
    ("  const int c = blockIdx.x;\n",
     "  const int c = blockIdx.x;\n  STAMP_DECL\n"),
    ("    __syncthreads();\n    if (p < n_pieces) {\n",
     "    __syncthreads();\n"
     "    if (p0 == 0) STAMP(0, 0); else STAMP(2, 0);\n"
     "    if (p < n_pieces) {\n"),
    ("part[p][q >> 5] = make_double2(re, im);\n    }\n",
     "part[p][q >> 5] = make_double2(re, im);\n    }\n"
     "    if (p0 == 0) STAMP(1, 0); else STAMP(3, 0);\n"),
    ("  }\n  __syncthreads();\n\n  const float sps",
     "  }\n  __syncthreads();\n  STAMP(4, 0);\n"
     "  if (threadIdx.x == 0) STAMPS_FLUSH(0);\n  STAMP_RESET;\n\n"
     "  const float sps"),
    ("    __syncwarp();\n    if (lane == 0) {\n",
     "    __syncwarp();\n    STAMP(0, 0);\n    if (lane == 0) {\n"),
    ("      s_tr[1] = rate;\n    }\n",
     "      s_tr[1] = rate;\n    }\n    STAMP(1, 0);\n"),
    ("  __syncthreads();\n  float* taps",
     "  __syncthreads();\n  STAMP(2, 0);\n  float* taps"),
    ("(i - s * a.L));\n  }\n}\n",
     "(i - s * a.L));\n  }\n  STAMP(3, 0);\n"
     "  if (threadIdx.x == 0) STAMPS_FLUSH(16);\n}\n"),
]
NEW_STAMPS = {
    0: "the piece's loads issued",
    1: "the wait for the piece, the group's barrier",
    2: "the sums",
    3: "the start barrier, the partials written to rank 0",
    16: "rank 0: its groups' barrier, the bank's copies issued, the centres",
    17: "rank 0: the end barrier, every partial here",
    18: "warp 0: the window combine and atan2s",
    19: "lane 0: the chain to its writes",
    20: "the segments",
    21: "the bank's wait and the barrier",
    22: "the taps gather",
    32: "rank 1: the piece's loads issued",
    33: "rank 1: the wait for the piece",
    34: "rank 1: the sums",
    35: "rank 1: the start barrier, the partials written",
}
NEW_STAMP_EDITS = [
    (INCLUDE, INCLUDE + PRELUDE),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  cg::cluster_group cluster = cg::this_cluster();\n  STAMP_DECL\n"),
    ("  cp_async_commit();\n  // the tracker's state",
     "  cp_async_commit();\n  STAMP(0, 0);\n  // the tracker's state"),
    ("    group_sync(g);                  // the whole piece has landed\n",
     "    group_sync(g);                  // the whole piece has landed\n"
     "    STAMP(1, 0);\n"),
    ("    cluster_wait();                 // every block of the cluster "
     "runs\n",
     "    STAMP(2, __double2loint(re) ^ __double2loint(im));\n"
     "    cluster_wait();                 // every block of the cluster "
     "runs\n"),
    ("      to[p * kWarpsPerGroup + (q >> 5)] = make_double2(re, im);\n",
     "      to[p * kWarpsPerGroup + (q >> 5)] = make_double2(re, im);\n"
     "    STAMP(3, 0);\n"
     "    if (threadIdx.x == 0 && rank < 2) STAMPS_FLUSH(32 * rank);\n"
     "    STAMP_RESET;\n"),
    ("  cluster_wait();                   // every piece's partials are "
     "here\n",
     "  STAMP(0, __float_as_int(den));\n"
     "  cluster_wait();                   // every piece's partials are "
     "here\n  STAMP(1, 0);\n"),
    ("    // window `lane`'s unwrap step from the one before, beside the "
     "others\n",
     "    STAMP(2, __float_as_int(tw));\n"
     "    // window `lane`'s unwrap step from the one before, beside the "
     "others\n"),
    ("      a.consumed[c] = a.n_out * a.sps + slip * a.sps;\n    }\n",
     "      a.consumed[c] = a.n_out * a.sps + slip * a.sps;\n    }\n"
     "    STAMP(3, 0);\n"),
    ("  cp_async_wait_all();              // this thread's bank copies\n",
     "  STAMP(4, 0);\n"
     "  cp_async_wait_all();              // this thread's bank copies\n"),
    ("  __syncthreads();                  // the bank and the subfilter "
     "indices\n",
     "  __syncthreads();                  // the bank and the subfilter "
     "indices\n  STAMP(5, 0);\n"),
    ("    taps[i] = bank_s[s_idx[s] * a.L + (i - s * a.L)];\n  }\n}\n",
     "    taps[i] = bank_s[s_idx[s] * a.L + (i - s * a.L)];\n  }\n"
     "  STAMP(6, 0);\n  if (threadIdx.x == 0) STAMPS_FLUSH(16);\n}\n"),
]
# clusters of 4 blocks of 4 pieces (512 threads, 2 blocks an SM)
NEW_G4 = [("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 4;"),
          ("constexpr int kMaxPer = 2;", "constexpr int kMaxPer = 4;"),
          ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 2;")]
# clusters of 6 blocks of 3 pieces (384 threads, <= 40 registers: 4 blocks
# an SM): at 64 channels every cluster resident at once
NEW_G6 = [("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 6;"),
          ("constexpr int kMaxPer = 2;", "constexpr int kMaxPer = 3;")]
# the blocks' first start, last start, first end and last end by
# %globaltimer (slots 48-51: a max, or the max of its complement for a
# min), and cudaOccupancyMaxActiveClusters at the plan's launch
WAVES = [
    (INCLUDE, INCLUDE + PRELUDE),
    ("  cluster_arrive_relaxed();         // this block runs",
     "  if (threadIdx.x == 0) {\n    const unsigned long long t0 = "
     "stamp_ns();\n    atomicMax(&g_stamps[49], t0);\n"
     "    atomicMax(&g_stamps[48], ~t0);\n  }\n"
     "  cluster_arrive_relaxed();         // this block runs"),
    ("    taps[i] = bank_s[s_idx[s] * a.L + (i - s * a.L)];\n  }\n}\n",
     "    taps[i] = bank_s[s_idx[s] * a.L + (i - s * a.L)];\n  }\n"
     "  if (threadIdx.x == 0) {\n    const unsigned long long t1 = "
     "stamp_ns();\n    atomicMax(&g_stamps[51], t1);\n"
     "    atomicMax(&g_stamps[50], ~t1);\n  }\n}\n"),
    ("extern \"C\" int ffsync_piece_samples()",
     "extern \"C\" int ffsync_max_clusters(int C, int n_pieces, "
     "int bank_floats) {\n"
     "  const TrackPlan p = track_plan(n_pieces);\n"
     "  const size_t smem = track_smem_bytes(p.per, bank_floats);\n"
     "  if (smem + kStaticSmem > 48 * 1024) cudaFuncSetAttribute("
     "ffsync_track_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
     "(int)smem);\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "  attr[0].val.clusterDim.x = p.G;\n  attr[0].val.clusterDim.y = 1;\n"
     "  attr[0].val.clusterDim.z = 1;\n"
     "  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(C * p.G);\n"
     "  cfg.blockDim = dim3(p.threads);\n  cfg.dynamicSmemBytes = smem;\n"
     "  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n  int n = -1;\n"
     "  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, "
     "ffsync_track_kernel, &cfg);\n"
     "  return e == cudaSuccess ? n : -(int)e;\n}\n\n"
     "extern \"C\" int ffsync_piece_samples()"),
]
EDITS = {
    "base": ("base", []),
    "base_stamps": ("base", BASE_STAMP_EDITS),
    "new": ("new", []),
    "new_stamps": ("new", NEW_STAMP_EDITS),
    "new_waves": ("new", WAVES),
    "new_g4": ("new", NEW_G4),
    "new_g4_waves": ("new", NEW_G4 + WAVES),
    "new_g6": ("new", NEW_G6),
    "new_g6_waves": ("new", NEW_G6 + WAVES),
}
PHASES = {"base_stamps": BASE_STAMPS, "new_stamps": NEW_STAMPS}
# (C, block samples, n_out, in place): the tracker's layouts
CASES = {"ccm": (64, 130_006, 64_980, True),
         "host": (1, 8_295, 4_096, False),
         "host16k": (1, 16_383, 8_140, False),
         "c8": (8, 16_383, 8_140, False)}


def _inputs(case, dev):
    """Seeded arguments of ``ffsync_cuda._launch`` for ``case``: noisy
    QPSK at 2 samples a symbol (one seeded stream, each channel from its
    own offset), half the channels' tracker state initialised; in place
    from a buffer 66,004 rows longer at starts that clamp at both ends."""
    import numpy as np
    import torch

    from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync

    C, n, n_out, in_place = CASES[case]
    rng = np.random.default_rng(2046)
    N = n + 66_004 if in_place else n
    sym = (rng.integers(0, 2, (C * 64 + N // 2 + 64, 2)) * 2 - 1) \
        .astype(np.float32) / np.sqrt(2)
    up = np.zeros((2 * sym.shape[0], 2), np.float32)
    up[::2] = sym
    pulse = np.hanning(9).astype(np.float32)
    wave = np.stack([np.convolve(up[:, k], pulse, "same") for k in (0, 1)], 1)
    wave += rng.normal(0, 0.1, wave.shape).astype(np.float32)
    x = np.stack([wave[64 * c + c % 2: 64 * c + c % 2 + N] for c in range(C)])
    sync = FeedForwardSync(sps=2, max_block=n_out, device=dev)
    start = None
    if in_place:
        s = rng.integers(0, N - n + 1, C)
        s[0], s[1], s[2] = -17, N, N - n - 3        # clamp, clamp, odd
        start = torch.as_tensor(s.astype(np.int32), device=dev)
    init = (np.arange(C) % 2).astype(np.int32)
    leaves = (torch.as_tensor(rng.uniform(0, 2, C).astype(np.float32),
                              device=dev),
              torch.as_tensor((rng.uniform(-1, 1, C) * 1e-4).astype(
                  np.float32), device=dev),
              torch.as_tensor(init, device=dev))
    return {"sync": sync, "leaves": leaves,
            "samples": torch.as_tensor(x, device=dev), "n_out": n_out,
            "start": start, "n": n, "S": sync.segments(n_out)}


def _digest(out):
    h = hashlib.sha256()
    state, taps, off, cons = out
    for t in (state.tau, state.rate, state.initialized, taps, off, cons):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _waves(lib, fn, a):
    """A ``_waves`` variant's block times over one launch, in ns from the
    first block's start: the last block's start, the first and the last
    block's end; and how many clusters of the plan can be resident at
    once (cudaOccupancyMaxActiveClusters) against the launch's."""
    import ctypes

    import torch

    from dvbs2rx_tpu_torch.ops import ffsync_cuda

    buf = (ctypes.c_ulonglong * 64)()
    lib.ffsync_stamps(buf)
    fn()
    torch.cuda.synchronize()
    lib.ffsync_stamps(buf)
    mask = (1 << 64) - 1
    first = buf[48] ^ mask
    C, n = a["samples"].shape[0], a["n"]
    _, W, wlen, _ = ffsync_cuda.windows(n, a["sync"].est_window)
    pieces = W * -(-wlen // ffsync_cuda.PIECE)
    lib.ffsync_max_clusters.argtypes = [ctypes.c_int] * 3
    return {"last_start_ns": buf[49] - first,
            "first_end_ns": (buf[50] ^ mask) - first,
            "last_end_ns": buf[51] - first,
            "max_active_clusters": lib.ffsync_max_clusters(
                C, pieces, a["sync"].bank.numel()),
            "clusters": C}


def child(root, names):
    """Build and run ``names`` (variants of ``root``'s source) in this
    process, with ``root``'s package: one JSON line per variant."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(Path(root).resolve()))
    from dvbs2rx_tpu_torch import _build
    from dvbs2rx_tpu_torch.ops import ffsync_cuda
    from dvbs2rx_tpu_torch.utils.runtime import exact_fp32

    exact_fp32()
    src = (Path(root) / "dvbs2rx_tpu_torch" / "csrc" / "ffsync.cu") \
        .read_text()
    t0 = time.perf_counter()
    libs, logs = build(ROOT / "build" / "ffsync_variants" / Path(root).name,
                       {n: apply_edits(src, EDITS[n][1]) for n in names})
    build_s = time.perf_counter() - t0
    for lib in libs.values():
        bind(lib, _build._SIGNATURES, "ffsync_")
    cases = {case: _inputs(case, "cuda") for case in CASES}

    def call(lib, a):
        real = _build.lib
        _build.lib = lambda: lib
        try:
            return ffsync_cuda._launch(**a)
        finally:
            _build.lib = real

    for name in names:
        lib = libs[name]
        rec = {"root": root, "build_s": build_s,
               "ptxas": {k: v for k, v in _build.ptxas_report(
                   logs[name]).items() if "ffsync" in k}}
        for case, a in cases.items():
            fn = (lambda lb=lib, a=a: call(lb, a))
            rec[f"{case}_track_digest"] = _digest(fn())
            real = _build.lib
            _build.lib = lambda lb=lib: lb
            try:
                held = chip_smoke._track_case(f"{name} {case}", a)
            finally:
                _build.lib = real
            rec[f"{case}_max_abs_err"] = held["max_abs_err"]
            rec[f"{case}_differ_near_edge"] = held["differ"]
            rec[f"{case}_device_ms"] = chip_smoke._profiled_device_ms(
                fn, "ffsync_track_kernel")
            if name in PHASES:
                rec[f"{case}_stamps"] = read_stamps(lib.ffsync_stamps, fn,
                                                    PHASES[name])
            if name.endswith("_waves"):
                rec[f"{case}_waves"] = _waves(lib, fn, a)
        print(json.dumps({name: rec}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--base", default=str(ROOT / "build" / "ab" / "parent"))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--stamps-only", action="store_true")
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.names)
    sys.path.insert(0, str(ROOT))
    from dvbs2rx_tpu_torch import bench

    names = args.names or [n for n in EDITS
                           if not args.stamps_only or "stamps" in n]
    roots = {"base": args.base, "new": str(ROOT)}
    groups = {side: [n for n in names if EDITS[n][0] == side]
              for side in roots}
    order = [s for s in roots if groups[s]]
    runs = []
    for _ in range(args.rounds):
        for side in order + order[::-1]:
            r = subprocess.run([sys.executable, __file__, "--child",
                                roots[side], *groups[side]],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{side}: exit {r.returncode}\n"
                                   f"{r.stderr[-4000:]}")
            for line in r.stdout.strip().splitlines():
                print(line, flush=True)
                runs.append(json.loads(line))
    digests = {case: sorted({rec[f"{case}_track_digest"] for run in runs
                             for rec in run.values()}) for case in CASES}
    print(json.dumps({
        "device_ms": {name: {case: [rec[f"{case}_device_ms"] for run in runs
                                    for n, rec in run.items() if n == name]
                             for case in CASES} for name in names},
        "track_digest": digests,
        "same_outputs": all(len(d) == 1 for d in digests.values())}))
    print(bench.smi())


if __name__ == "__main__":
    sys.exit(main())
