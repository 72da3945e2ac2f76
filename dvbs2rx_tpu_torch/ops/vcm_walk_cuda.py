"""The VCM receiver's decoded-PLS chain walk through a CUDA kernel.

The JAX ``VCMStreamReceiver._walk`` (``dvbs2rx_tpu/rx/vcm_stream.py:397-470``)
is a ``lax.scan`` of K_max slots, with no Pallas kernel. Its plain PyTorch
version, ``VCMStreamReceiver._walk_plain`` (``rx/vcm_stream.py``), runs
each slot as ~240 small launches: the 94-symbol window, the 3-point frame
metric, the re-align, the PLSC decode and the PLS -> frame length lookup.
One launch of ``csrc/vcm_walk.cu`` walks every channel's chain: its source
note says how, and what bounds it. ``tables`` gives the kernel its
constants (metric taps, SOF symbols, derotation factors, frame lengths and
the scrambled Reed-Muller images as bits); the receiver's search mask goes
to it as the (128,) bool tensor it already holds on the card.

``VCMStreamReceiver._walk`` dispatches by the symbol ring's device: CPU
tensors take the plain loop; CUDA tensors launch this kernel or raise. The
wrapper reads nothing back and copies nothing from the host (its tables
come through ``utils.runtime.device_table``), so a CUDA graph can hold it.
"""

import functools

import numpy as np
import torch

from .. import _build
from ..spec.pls import parse_pls
from ..utils.runtime import device_table
from . import plsync

LAUNCHES = 0     # kernel launches; incremented only where the kernel runs
LAUNCH_SHAPES = {}  # the same launches by (C, N_SYM, K)


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_SHAPES.clear()


_build.register_counter("vcm_walk", lambda: LAUNCHES, _reset_counts)

# the PLSC modes in csrc/vcm_walk.cu's order (RxConfig.plsc_mode names)
MODES = ("coherent-soft", "coherent-hard", "differential")
WINDOW = 94           # kExt: the window [pos - 2, pos + 92)
HEADER = 90


@functools.lru_cache(maxsize=1)
def float_table() -> np.ndarray:
    """(268, 2) float32, the kernel's float constants in its order: the
    frame metric's SOF and PLSC taps (89 each, ``plsync.frame_metric``'s),
    the 26 conj SOF symbols (``sof_phase``'s) and the 64 pi/2-BPSK
    derotation factors of the PLSC symbols."""
    ks, kp = plsync._frame_metric_taps()
    sof = plsync.plheader_conj_lut()[0, :26]
    return np.ascontiguousarray(np.concatenate(
        [ks, kp, sof, plsync._pi2_derot_factors()]).astype(np.float32))


@functools.lru_cache(maxsize=1)
def int_table() -> np.ndarray:
    """(384,) int32, the kernel's integer table: the PLFRAME length of
    each PLS (128), then the scrambled Reed-Muller images as bits (word
    2p + k // 32, bit k % 32 set where image p is -1; 256 words)."""
    L = np.array([parse_pls(p).plframe_len for p in range(128)], np.uint32)
    img = plsync._rm_images()
    if not np.array_equal(np.abs(img), np.ones_like(img)):
        raise AssertionError("the PLSC images must be +-1")
    bits = (img < 0).reshape(128, 2, 32).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return np.concatenate([L, words.reshape(-1)]).view(np.int32)


def vcm_walk(symbuf, fp_right, symfill, pls, corrected, search_mask,
             K: int, L_max: int, mode: str):
    """One launch of the chain walk. symbuf (C, N_SYM, 2) float32, the
    ring; fp_right, symfill, pls (C,) int32; corrected (C,) bool; the
    search mask (128,) bool, True for the searched PLS; K slots; L_max
    the longest expected PLFRAME; ``mode`` the coherent PLSC mode. Returns what
    ``VCMStreamReceiver._walk`` returns: (slots {pos, pls, next_pls (K, C)
    int64, valid (K, C) bool, metric (K, C) float32, own_hdr, next_hdr (K,
    C, 90, 2) float32}, N_SYM - pos (C,) int64, the carried PLS (C,) int64,
    frames walked (C,) int32)."""
    global LAUNCHES
    if symbuf.dtype != torch.float32 or symbuf.dim() != 3 \
            or symbuf.shape[2] != 2 or symbuf.shape[1] < WINDOW:
        raise ValueError(f"symbuf {tuple(symbuf.shape)} {symbuf.dtype}: the "
                         f"kernel takes (C, N_SYM >= {WINDOW}, 2) float32")
    C, n_sym = symbuf.shape[0], symbuf.shape[1]
    for name, x, dt, want in (
            ("fp_right", fp_right, torch.int32, (C,)),
            ("symfill", symfill, torch.int32, (C,)),
            ("pls", pls, torch.int32, (C,)),
            ("coarse_corrected", corrected, torch.bool, (C,)),
            ("search_mask", search_mask, torch.bool, (128,))):
        if x.dtype != dt or tuple(x.shape) != want:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: the kernel "
                             f"takes {want} {dt}")
    ins = (symbuf, fp_right, symfill, pls, corrected, search_mask)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("the walk's inputs must be contiguous")
    if mode not in MODES:
        raise ValueError(f"PLSC mode {mode!r}: the kernel takes {MODES}")
    if not (K >= 1 and 0 < L_max):
        raise ValueError(f"K {K}, L_max {L_max}")
    if not symbuf.is_cuda:
        raise ValueError("the kernel takes CUDA tensors; the plain loop is "
                         "VCMStreamReceiver._walk_plain")
    dev = symbuf.device
    if any(x.device != dev for x in ins):
        raise ValueError("the walk's inputs must share one device")
    if symbuf.data_ptr() % 8:
        raise ValueError("symbuf must be 8-byte aligned")
    ft = device_table(float_table(), dev)
    it = device_table(int_table(), dev)

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    slots = {"pos": out((K, C), torch.int64), "pls": out((K, C), torch.int64),
             "valid": out((K, C), torch.bool),
             "own_hdr": out((K, C, HEADER, 2), torch.float32),
             "metric": out((K, C), torch.float32),
             "next_pls": out((K, C), torch.int64),
             "next_hdr": out((K, C, HEADER, 2), torch.float32)}
    fp_out, pls_out = out((C,), torch.int64), out((C,), torch.int64)
    n_walked = out((C,), torch.int32)
    err = _build.lib().vcm_walk_launch(
        symbuf.data_ptr(), fp_right.data_ptr(), symfill.data_ptr(),
        pls.data_ptr(), corrected.data_ptr(), ft.data_ptr(), it.data_ptr(),
        search_mask.data_ptr(), slots["pos"].data_ptr(),
        slots["pls"].data_ptr(), slots["valid"].data_ptr(),
        slots["own_hdr"].data_ptr(), slots["metric"].data_ptr(),
        slots["next_pls"].data_ptr(), slots["next_hdr"].data_ptr(),
        fp_out.data_ptr(), pls_out.data_ptr(), n_walked.data_ptr(), C,
        n_sym, K, L_max, MODES.index(mode),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vcm_walk_kernel")
    LAUNCHES += 1
    key = (C, n_sym, K)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    return slots, fp_out, pls_out, n_walked
