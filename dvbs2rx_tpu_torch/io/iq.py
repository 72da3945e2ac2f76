"""IQ sample IO: fc32/u8 file and fd streams.

Copy of ``dvbs2rx_tpu/io/iq.py``: complex float32 ("fc32") native format,
and interleaved unsigned 8-bit ("u8", RTL-SDR style, offset 127.5) with
conversion to fc32 (the reference app's source chain,
``apps/dvbs2-rx:674-716``).
"""

import os
import sys

import numpy as np

from . import native


def u8_to_fc32(raw: np.ndarray) -> np.ndarray:
    """Interleaved u8 IQ -> complex64 (native C fast path when built)."""
    return native.u8_to_fc32(raw)


def fc32_to_u8(iq: np.ndarray, scale: float = 0.9) -> np.ndarray:
    return native.fc32_to_u8(iq, scale)


def read_iq(path_or_fd, fmt: str = "fc32") -> np.ndarray:
    """Read an entire IQ stream from a file path, '-' (stdin), or fd int."""
    if path_or_fd in ("-", None):
        raw = sys.stdin.buffer.read()
    elif isinstance(path_or_fd, int):
        chunks = []
        while True:
            b = os.read(path_or_fd, 1 << 20)
            if not b:
                break
            chunks.append(b)
        raw = b"".join(chunks)
    else:
        with open(path_or_fd, "rb") as f:
            raw = f.read()
    if fmt == "fc32":
        return np.frombuffer(raw, dtype=np.complex64)
    if fmt == "u8":
        return u8_to_fc32(np.frombuffer(raw, dtype=np.uint8))
    raise ValueError(f"unknown IQ format {fmt!r}")


def iter_iq(path_or_fd, fmt: str = "fc32", chunk_samples: int = 1 << 20):
    """Stream IQ samples in chunks (generator). A read that ends inside a
    sample (a pipe returns short reads) carries the partial sample's bytes
    into the next read: 8 bytes per fc32 sample, 2 per u8 sample."""
    if path_or_fd in ("-", None):
        yield from _iter_reader(sys.stdin.buffer.read, fmt, chunk_samples)
    elif isinstance(path_or_fd, int):
        yield from _iter_reader(lambda n: os.read(path_or_fd, n), fmt,
                                chunk_samples)
    else:
        with open(path_or_fd, "rb") as f:
            yield from _iter_reader(f.read, fmt, chunk_samples)


def _iter_reader(reader, fmt, chunk_samples):
    itemsize = 8 if fmt == "fc32" else 2
    pending = b""
    while True:
        b = reader(chunk_samples * itemsize)
        if not b:
            break
        b = pending + b
        usable = len(b) - (len(b) % itemsize)
        pending = b[usable:]
        buf = b[:usable]
        if fmt == "fc32":
            yield np.frombuffer(buf, dtype=np.complex64)
        else:
            yield u8_to_fc32(np.frombuffer(buf, dtype=np.uint8))


def write_iq(path_or_fd, iq: np.ndarray, fmt: str = "fc32"):
    if fmt == "fc32":
        data = np.asarray(iq, dtype=np.complex64).tobytes()
    elif fmt == "u8":
        data = fc32_to_u8(iq).tobytes()
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")
    if path_or_fd in ("-", None):
        sys.stdout.buffer.write(data)
    elif isinstance(path_or_fd, int):
        os.write(path_or_fd, data)
    else:
        with open(path_or_fd, "wb") as f:
            f.write(data)
