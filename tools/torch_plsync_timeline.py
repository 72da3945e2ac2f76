#!/usr/bin/env python3
"""Per-block timelines of the PL sync kernels on the card.

    python3 tools/torch_plsync_timeline.py

Copies ``dvbs2rx_tpu_torch/csrc/plsync.cu`` with ``%globaltimer`` stamps at
four points of each kernel into ``build/plsync_timeline/``: the block's
entry; the end of its set-up (the header's loads; the statistics
kernel's lane values, pilot phases and fine CFO; the demap kernel's lane
reduction and ranks); the end of its main work (the header's sums and
phases; the statistics' symbol loop; the demap's derotate-and-stage
loop); and its end (after the lag sums; the partial-sum store; the
write-out). Builds the copy with nvcc (the package's flags), points the
wrapper at it, and runs ``tools/torch_kernel_ab.py``'s PL sync cases
(the CCM step's shape and the VCM step's, on seeded symbols) once after
three warm-ups. Prints one JSON line per kernel and case: blocks that ran
to their end, the span from the first entry to the last end (us), the
block time and each phase's median and 90th percentile, when blocks
started, and the most blocks live at once on each of the first 20 SMs.
The stamps cost registers and stores, so the times run a little above
the kernels' own. Needs one CUDA card and nvcc.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "plsync_timeline"
# stamp slots a block: 4 times and its SM; kernel k's blocks at k x BASE
SLOTS, BASE = 6, 65536
KERNELS = ("stats", "demap", "header")

STAMP = r'''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ void stamp(int slot, long long base) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    unsigned int sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const long long blk =
        base + (long long)blockIdx.y * gridDim.x + blockIdx.x;
    g_stamps[blk * 6 + slot] = t;
    g_stamps[blk * 6 + 5] = sm;
  }
}
'''


def _insert(src, marker, text, before=False):
    """``text`` after (or before) the one occurrence of ``marker``."""
    if src.count(marker) != 1:
        raise RuntimeError(f"plsync.cu: {src.count(marker)} places for a "
                           f"stamp at {marker!r}")
    i = src.index(marker)
    if not before:
        i += len(marker)
    return src[:i] + text + src[i:]


def stamped_source():
    src = (ROOT / "dvbs2rx_tpu_torch" / "csrc" / "plsync.cu").read_text()
    src = _insert(src, "namespace {\n\nconstexpr int kHdrThreads", STAMP,
                  before=True)
    st, dm, hd = (f", {k * BASE}" for k in range(3))
    marks = [
        ("plsync_stats_kernel(PayloadArgs a) {", f"\n  stamp(0{st});"),
        ("  if (kKind != kQPSK) __syncthreads();\n", f"  stamp(1{st});\n"),
        ("  sp = warp_sum(sp);\n", None),
        ("    out[1] = tnp;\n", f"    stamp(3{st});\n"),
        ("plsync_demap_kernel(PayloadArgs a) {", f"\n  stamp(0{dm});"),
        ("  if (n_on == 0) return;\n", f"  stamp(1{dm});\n"),
        ("  // write-out, a run at a time", None),
        ("                     int pls_stride, int n_auto) {",
         f"\n  stamp(0{hd});"),
        ("    pd[n1] = make_double2(p1.x, p1.y);\n  }\n  __syncthreads();\n",
         f"  stamp(1{hd});\n"),
        ("  if (j == 0 && 2 * t < n_auto) {", None),
    ]
    before = {"  sp = warp_sum(sp);\n": f"  stamp(2{st});\n",
              "  // write-out, a run at a time": f"  stamp(2{dm});\n",
              "  if (j == 0 && 2 * t < n_auto) {": f"  stamp(2{hd});\n"}
    for marker, text in marks:
        if text is None:
            src = _insert(src, marker, before[marker], before=True)
        else:
            src = _insert(src, marker, text)
    # the demap's and the header's ends: after their last loop
    src = _insert(src, "          dst[off * a.l_pos + r * a.l_lane] = "
                  "src[off * kStageRow + r];\n      }\n    }\n  }\n",
                  f"  __syncthreads();\n  stamp(3{dm});\n")
    src = _insert(src, "lag_sum(pd, n_auto - m, n_auto);\n  }\n",
                  f"  __syncthreads();\n  stamp(3{hd});\n")
    return src + r'''
extern "C" int plsync_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
'''


def build():
    from dvbs2rx_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "plsync_stamped.cu", OUT / "libplsync_stamped.so"
    cu.write_text(stamped_source())
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, args in _build._SIGNATURES.items():
        if name.startswith("plsync"):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    lib.plsync_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def summary(name, d):
    """The JSON record of one kernel's stamps d (blocks, SLOTS) in ns."""
    d = d[(d[:, 0] > 0) & (d[:, 3] > 0)]
    t0 = d[:, 0].min()

    def pct(x):
        return [float(np.percentile(x, 50)), float(np.percentile(x, 90))]

    live = []
    for sm in np.unique(d[:, 5])[:20]:
        ev = sorted([(x, 1) for x in d[d[:, 5] == sm, 0]]
                    + [(x, -1) for x in d[d[:, 5] == sm, 3]])
        n = most = 0
        for _, e in ev:
            n += e
            most = max(most, n)
        live.append(most)
    return {"kernel": name, "blocks": int(len(d)),
            "span_us": float((d[:, 3].max() - t0) / 1e3),
            "block_us_p50_p90": pct((d[:, 3] - d[:, 0]) / 1e3),
            "setup_us_p50_p90": pct((d[:, 1] - d[:, 0]) / 1e3),
            "work_us_p50_p90": pct((d[:, 2] - d[:, 1]) / 1e3),
            "end_us_p50_p90": pct((d[:, 3] - d[:, 2]) / 1e3),
            "start_us_p50_p90": pct((d[:, 0] - t0) / 1e3),
            "live_per_sm": live}


def main():
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_kernel_ab
    from dvbs2rx_tpu_torch import _build, bench
    from dvbs2rx_tpu_torch.ops import plsync_cuda

    print(bench.smi(), flush=True)
    lib = build()
    _build.lib = lambda: lib
    stamps = torch.zeros(len(KERNELS) * BASE * SLOTS, dtype=torch.int64,
                         device="cuda")
    if lib.plsync_set_stamps(stamps.data_ptr()) != 0:
        raise RuntimeError("could not set the stamp buffer")
    for key, fn, _ in torch_kernel_ab.plsync_cases(plsync_cuda):
        for _ in range(3):
            fn()
        stamps.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        d = stamps.view(len(KERNELS), BASE, SLOTS).cpu().numpy()
        names = ("header",) if "header" in key else ("stats", "demap")
        for name in names:
            rec = summary(name, d[KERNELS.index(name)])
            print(json.dumps({"case": key, **rec}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
