"""Build the CUDA kernels with nvcc and load them with ctypes.

``csrc/*.cu`` compile in parallel (one nvcc per source, all started
together) and link into ONE shared library with a plain C interface (no
PyTorch headers, so the build takes seconds, not minutes) under
``build/dvbs2rx_tpu_torch/`` beside the package, named by a hash of the
sources: a changed source builds a new library, an unchanged one is reused.
The build runs at the first kernel launch, never at import, so importing
the package needs no nvcc.

Every entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when it is not 0.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dvbs2rx_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry point: c_void_p for each pointer and the
# stream, c_int for each int (ctypes would otherwise cut a pointer to 32
# bits), c_longlong for each long long, c_float for each float
# the payload's two kernels take the same arguments
_PAYLOAD_ARGS = ([_P] * 14 + [_I] * 2 + [_L] * 5 + [_I] * 6 + [_L] * 2
                 + [_I] * 2 + [_F] + [_I] * 7 + [_P])
_SIGNATURES = {
    "bch_locator_launch": [_P] * 9 + [_I] * 7 + [_P],
    "bch_chien_launch": [_P] * 6 + [_I] * 2 + [_P] + [_I] * 4 + [_P],
    "crc8_validity_launch": [_P] * 4 + [_I] * 4 + [_P],
    "gardner_launch": [_P] * 16 + [_I] * 11 + [_F] * 4 + [_P],
    "gardner_smem_bytes": [_I] * 2,
    "mf_segmented_launch": [_P] * 4 + [_I] * 9 + [_P, _I, _P],
    "mf_segmented_smem_bytes": [_I] * 2,
    "mf_segmented_grid_blocks": [_I] * 2,
    "ldpc_layered_launch": [_P] * 6 + [_I] * 8 + [_P],
    "ldpc_layered_smem_bytes": [_I] * 4,
    "vcm_walk_launch": [_P] * 27 + [_I] * 7 + [_P],
    "plsync_header_launch": [_P] * 9 + [_I] * 3 + [_L] * 4 + [_I] * 2 + [_P],
    "plsync_stats_launch": _PAYLOAD_ARGS,
    "plsync_demap_launch": _PAYLOAD_ARGS,
    "frontend_launch": [_P] * 13 + [_I] * 4 + [_F] * 4 + [_P],
    "frontend_chunk_samples": [],
    "frontend_tile_rows": [],
    "ffsync_track_launch": [_P] * 15 + [_I] * 13 + [_F] * 6 + [_P],
    "ffsync_piece_samples": [],
    "ffsync_track_plan": [_I],
    "ffsync_track_smem_bytes": [_I] * 2,
    "snr_refine_launch": [_P] * 8 + [_L] * 3 + [_I] * 6 + [_P],
    "rxspan_launch": [_I, _P],
    "rxspan_graph_nodes": [_P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of the last nvcc run (None: cached)
build_log = ""              # nvcc's output (-Xptxas -v register/smem report)


def ptxas_report(log: str = None):
    """Per kernel function of the -Xptxas -v report: {mangled name:
    {"registers", "stack", "spill_stores", "spill_loads"}}."""
    out, name = {}, None
    for line in (build_log if log is None else log).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc():
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdvbs2rx_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds, build_log
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        if log.exists():
            build_log = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tmp = out.with_name(out.name + f".{pid}.tmp")
    t0 = time.perf_counter()
    jobs = []
    for cu in sorted(SRC_DIR.glob("*.cu")):
        obj = out.with_name(f"{out.stem}.{cu.stem}.{pid}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(obj),
               str(cu)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for _, p in jobs:
        logs.append(p.communicate()[0])
        if p.returncode != 0:
            failed.append(p.returncode)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
    r = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                        *(str(o) for o, _ in jobs)],
                       capture_output=True, text=True)
    for o, _ in jobs:
        o.unlink()
    build_seconds = time.perf_counter() - t0
    build_log += r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{build_log}")
    log.write_text(build_log)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


_COUNTERS = {}      # kernel -> (read, reset), registered by its wrapper


def register_counter(kernel: str, read, reset):
    """Each wrapper registers its kernel's launch counter when it is
    imported: ``read()`` gives the count, ``reset()`` sets it to 0 with
    whatever the wrapper counts beside it (shapes, speculation)."""
    _COUNTERS[kernel] = (read, reset)


def launch_counts() -> dict:
    """How many times this process launched each hand-written kernel, by
    kernel (the wrappers' counters; a CUDA graph's replays are not seen)."""
    return {k: read() for k, (read, _) in _COUNTERS.items()}


def reset_launch_counts():
    """Every wrapper's counters to 0."""
    for _, reset in _COUNTERS.values():
        reset()


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
