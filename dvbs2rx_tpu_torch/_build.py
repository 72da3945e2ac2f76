"""Build the CUDA kernels with nvcc and load them with ctypes.

``csrc/*.cu`` compile into ONE shared library with a plain C interface
(no PyTorch headers, so the build takes seconds, not minutes) under
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
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dvbs2rx_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point: c_void_p for each pointer and the
# stream, c_int for each int (ctypes would otherwise cut a pointer to 32
# bits)
_SIGNATURES = {
    "mf_segmented_launch": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "ldpc_layered_launch": [_P] * 10 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of the last nvcc run (None: cached)
build_log = ""              # nvcc's output (-Xptxas -v register/smem report)


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
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    cu = [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
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


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
