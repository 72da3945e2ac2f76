"""What the kernel-variant tools share: a parallel nvcc build of text-edited
copies of a kernel source, and timing in turns.

``tools/torch_mf_variants.py``, ``tools/torch_gardner_variants.py``,
``tools/torch_bch_variants.py`` and ``tools/torch_crc8_variants.py``
import it (they run as scripts, so this directory is on their path). The
last two read ``clock64()`` stamps per kernel phase through
``stamps_prelude`` and ``read_stamps``.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


_STAMPS_PRELUDE = r'''
__device__ unsigned long long g_stamps[64];
__device__ __forceinline__ long long stamp_now(int dep) {
  int sink;
  long long t;
  asm volatile("add.s32 %0, %1, 0;" : "=r"(sink) : "r"(dep));
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}
#define STAMP(slot, dep) do { const long long _t = stamp_now((int)(dep)); \
  stamp_acc[slot] += _t - t_last; t_last = _t; } while (0)
#define STAMP_DECL long long stamp_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \
  long long t_last = clock64(); unsigned long long ns0 = stamp_ns();
#define STAMP_RESET do { for (int _j = 0; _j < 8; ++_j) stamp_acc[_j] = 0; \
  t_last = clock64(); ns0 = stamp_ns(); } while (0)
#define STAMPS_FLUSH(slot0) do { stamp_acc[7] = stamp_ns() - ns0; \
  stamps_flush(stamp_acc, slot0); } while (0)
__device__ __forceinline__ void stamps_flush(const long long* acc, int slot0) {
  for (int j = 0; j < 8; ++j)
    atomicAdd(&g_stamps[slot0 + j], (unsigned long long)acc[j]);
  atomicAdd(&g_stamps[slot0 + 8], 1ull);
}
extern "C" int STAMPS_FN(void* out) {
  static const unsigned long long zero[64] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamps, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
  return (int)e;
}
'''


def stamps_prelude(fn):
    """CUDA text that a stamped variant puts after its includes: a device
    array of 64 cycle sums, the STAMP macros (``STAMP_DECL`` opens a
    thread's accumulators, ``STAMP(slot, dep)`` adds the cycles since the
    last stamp to ``slot`` once ``dep`` exists, ``STAMPS_FLUSH(slot0)``
    adds slots slot0..slot0 + 6, the %globaltimer nanoseconds at slot0 + 7
    and a count of 1 at slot0 + 8), and ``extern "C" int fn(void* out)``,
    which copies the 64 sums out and sets them to 0."""
    return _STAMPS_PRELUDE.replace("STAMPS_FN", fn)


def read_stamps(fn, run, phases):
    """Run ``run()`` between two calls of a variant's stamps function
    ``fn`` (the first clears): {phase: {"cycles": mean over the stamped
    units, "units"}} for each {slot: phase} of ``phases``, and each group
    of 16 slots' cycles per nanosecond."""
    import torch

    buf = (ctypes.c_ulonglong * 64)()
    fn(buf)
    run()
    torch.cuda.synchronize()
    if fn(buf):
        raise RuntimeError("reading the stamps failed")
    out = {}
    for slot, what in phases.items():
        n = buf[(slot // 16) * 16 + 8]
        out[what] = {"cycles": buf[slot] / max(n, 1), "units": n}
    for g in sorted({slot // 16 * 16 for slot in phases}):
        cyc = sum(buf[g + k] for k in range(7))
        out[f"group {g}: cycles per ns"] = cyc / max(buf[g + 7], 1)
    return out


def apply_edits(text, edits):
    """``text`` with each (old, new) of ``edits`` replaced; each old text
    must occur exactly once, so an edit that no longer fits its source
    fails loudly instead of doing nothing."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not fit its source once: {old!r}")
        text = text.replace(old, new)
    return text


def build(out_dir, sources):
    """Compile every {name: CUDA source text} with the package's nvcc flags
    into ``out_dir/<name>.so``, all processes at once. Returns ({name:
    ctypes.CDLL}, {name: nvcc's output, the -Xptxas -v report}); raises
    with the log if one fails."""
    from dvbs2rx_tpu_torch import _build

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs, logs = {}, {}
    for name, (so, p) in jobs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(so)), log
    return libs, logs


def bind(lib, signatures, prefix):
    """Set argtypes (and an int result) for every function of
    ``signatures`` ({name: argtypes}, as ``_build._SIGNATURES``) whose name
    starts with ``prefix``."""
    for fn, args in signatures.items():
        if fn.startswith(prefix):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int


def time_in_turns(calls, rounds, runs):
    """{name: [ms, ...]}: each round times every call of ``calls`` ({name:
    fn}) with ``chip_smoke._time_ms(fn, runs)``, in order and then in
    reverse, so a drift of the card's clock over the run falls on all."""
    import chip_smoke

    names = list(calls)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            times[name].append(chip_smoke._time_ms(calls[name], runs))
    return times
