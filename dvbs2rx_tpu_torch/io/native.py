"""Loader of the repository's native host extension, with numpy versions.

The C extension (``native/dvbs2rx_native.c`` at the repository root) runs
the host TS stitch loops and the u8 <-> fc32 IQ conversions. Build it
with::

    cd native && python setup.py build_ext --inplace

The port calls its flagged stitch entry points (``ts_stitch_flagged`` and
``ts_stitch_flagged_batch``) and the IQ conversions. Without the extension,
``spec/bb_frame.py`` runs its numpy stitch, which gives the same bytes, and
``u8_to_fc32``/``fc32_to_u8`` their numpy versions below.
"""

import glob
import importlib.util
import os

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ext = None


def load():
    """The extension module, or False when it is not built."""
    global _ext
    if _ext is not None:
        return _ext
    try:
        # pip-installed build (setup.py places dvbs2rx_native on sys.path)
        import dvbs2rx_native as mod

        _ext = mod
        return _ext
    except ImportError:
        pass
    for pat in ("native/dvbs2rx_native*.so",
                "native/build/**/dvbs2rx_native*.so"):
        hits = glob.glob(os.path.join(_ROOT, pat), recursive=True)
        if hits:
            spec = importlib.util.spec_from_file_location("dvbs2rx_native",
                                                          hits[0])
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _ext = mod
            return _ext
    _ext = False
    return _ext


def has_ts_stitch_flagged() -> bool:
    ext = load()
    return bool(ext) and hasattr(ext, "ts_stitch_flagged")


def u8_to_fc32(raw: np.ndarray) -> np.ndarray:
    """Interleaved u8 IQ (offset 127.5) -> complex64."""
    ext = load()
    if ext:
        out = ext.u8_to_fc32(np.asarray(raw, np.uint8).tobytes())
        return np.frombuffer(out, np.float32).view(np.complex64)
    x = (np.asarray(raw, np.uint8).astype(np.float32) - 127.5) / 127.5
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def fc32_to_u8(iq: np.ndarray, scale: float = 0.9) -> np.ndarray:
    """complex64 -> interleaved u8 IQ: rint(x * scale * 127.5 + 127.5),
    clipped to [0, 255]."""
    ext = load()
    x = np.empty(np.asarray(iq).size * 2, np.float32)
    x[0::2] = np.real(iq)
    x[1::2] = np.imag(iq)
    if ext:
        return np.frombuffer(ext.fc32_to_u8(x.tobytes(), scale), np.uint8)
    return np.clip(np.rint(x * scale * 127.5 + 127.5), 0, 255).astype(np.uint8)


def _as_buf(a):
    """Zero-copy buffer handoff when the array is already contiguous u8
    (the hot-loop case); the C side takes any buffer-protocol object."""
    a = np.asarray(a, np.uint8)
    return a if a.flags["C_CONTIGUOUS"] else np.ascontiguousarray(a)


def ts_stitch_flagged(datafield: np.ndarray, partial: np.ndarray,
                      synched: bool, syncd_bytes: int, ok_map: np.ndarray,
                      base_idx: int):
    """Stitch one datafield with device-precomputed packet validity
    (``ops/crc8_dev.packet_validity`` packed map; ``base_idx`` = the
    datafield's byte offset inside the frame). Only the one cross-frame
    packet per call computes a CRC on the host. Returns (ts, new_partial,
    n_errors), the arrays read-only views over the C-allocated buffers."""
    ts, new_partial, n_err = load().ts_stitch_flagged(
        _as_buf(datafield), _as_buf(partial), bool(synched),
        int(syncd_bytes), _as_buf(ok_map), int(base_idx),
    )
    return (
        np.frombuffer(ts, np.uint8),
        np.frombuffer(new_partial, np.uint8),
        int(n_err),
    )
