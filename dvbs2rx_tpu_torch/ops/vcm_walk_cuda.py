"""The VCM receiver's chain walk and its per-slot books through one CUDA
kernel.

The JAX ``VCMStreamReceiver._walk`` (``dvbs2rx_tpu/rx/vcm_stream.py:397-470``)
is a ``lax.scan`` of K_max slots, with no Pallas kernel, and the step scans
the walked slots again for the lane compaction (``:603-624``), the lock
upkeep (``:673-685``) and the coarse CFO (``:687-733``). Their plain
PyTorch version, ``VCMStreamReceiver._walk_books_plain``
(``rx/vcm_stream.py``), runs ``_walk_plain`` (each slot ~240 small
launches: the 94-symbol window, the 3-point frame metric, the re-align,
the PLSC decode, the PLS -> frame length lookup) and then the books. One
launch of ``csrc/vcm_walk.cu`` walks every channel's chain and keeps its
books: its source note says how, and what bounds it. ``float_table`` and
``int_table`` give the kernel its constants (metric taps, SOF symbols,
derotation factors, coarse weights, frame lengths, the PLSC transform's
PLS table, the scrambler and dummy bits); the conj PLHEADER table and the
receiver's search and output masks go to it as the tensors they are.

``VCMStreamReceiver._walk_books`` dispatches by the symbol ring's device:
CPU tensors take the plain composite; CUDA tensors launch this kernel or
raise. The wrapper reads nothing back and copies nothing from the host
(its tables come through ``utils.runtime.device_table``), so a CUDA graph
can hold it.
"""

import functools

import numpy as np
import torch

from .. import _build
from ..spec.pl_defs import PLSC_SCRAMBLER_BITS
from ..spec.pls import parse_pls
from ..utils.runtime import device_table
from . import plsync

LAUNCHES = 0     # kernel launches; incremented only where the kernel runs
LAUNCH_SHAPES = {}  # the same launches by (C, N_SYM, K, F_pay)


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_SHAPES.clear()


_build.register_counter("vcm_walk", lambda: LAUNCHES, _reset_counts)

# the PLSC modes in csrc/vcm_walk.cu's order (RxConfig.plsc_mode names)
MODES = ("coherent-soft", "coherent-hard", "differential")
WINDOW = 96           # kWin: the window [pos - 3, pos + 93) of three shifts
HEADER = 90
LAGS = 89
MAX_K = 64            # kMaxK: slots (and lanes) a channel, at most
# the state leaves the kernel reads: (C,) int32, (C,) bool, the
# accumulator, (C,) float32
INT_LEAVES = ("fp_right", "symfill", "pls", "unlock_cnt", "coarse_frames",
              "settle")


@functools.lru_cache(maxsize=1)
def float_table() -> np.ndarray:
    """(360, 2) float32, the kernel's float constants in its order: the
    frame metric's SOF and PLSC taps (89 each, ``plsync.frame_metric``'s),
    the 26 conj SOF symbols (``sof_phase``'s), the 64 pi/2-BPSK
    derotation factors of the PLSC symbols, the 89 coarse weights (w, 0),
    then (pi, 2 pi), (FINE_FOFFSET_CORR_RANGE, THRESHOLD_LOCKED) and
    (1 / 2 pi, 0) as float32 (torch compares and subtracts a Python scalar
    in float32, and divides by one as a product with its float32
    reciprocal on the card)."""
    ks, kp = plsync._frame_metric_taps()
    sof = plsync.plheader_conj_lut()[0, :26]
    w = plsync.coarse_weights(HEADER)
    two_pi = np.float32(2 * np.pi)
    consts = np.array([[np.pi, 2 * np.pi],
                       [plsync.FINE_FOFFSET_CORR_RANGE,
                        plsync.THRESHOLD_LOCKED],
                       [np.float32(1.0) / two_pi, 0.0]], np.float32)
    return np.ascontiguousarray(np.concatenate(
        [ks, kp, sof, plsync._pi2_derot_factors(),
         np.stack([w, np.zeros_like(w)], axis=1), consts]).astype(np.float32))


def wht_table() -> np.ndarray:
    """(32, 2, 2) int: entry [j, b, s] is the PLS whose PLSC score is
    (-1)^s T_b[j], T_b the 32-point Walsh-Hadamard transform (natural
    order) of u_b[m] = v[2m] + (-1)^b v[2m + 1], v the descrambled PLSC
    values: a PLS's 6 high bits pick a first-order Reed-Muller (32, 6)
    codeword y (the all-ones row is s, the others index j), its low bit b
    interleaves y with y or with its complement. Built from, and checked
    against, the scrambled images the plain decoders correlate with."""
    img = plsync._rm_images()
    scr = 1.0 - 2.0 * PLSC_SCRAMBLER_BITS.astype(np.float64)
    m = np.arange(32)
    out = np.full((32, 2, 2), -1, np.int64)
    for j in range(32):
        walsh = 1.0 - 2.0 * (np.array([bin(x).count("1") for x in m & j]) & 1)
        for b in range(2):
            for s in range(2):
                pat = np.empty(64)
                pat[0::2] = walsh
                pat[1::2] = walsh * (1 - 2 * b)
                pat *= 1 - 2 * s
                hit = np.flatnonzero((img == scr * pat).all(axis=1))
                if hit.size != 1:
                    raise AssertionError(f"no PLS has pattern {(j, b, s)}")
                out[j, b, s] = hit[0]
    if sorted(out.ravel()) != list(range(128)):
        raise AssertionError("the transform table must cover every PLS once")
    return out


@functools.lru_cache(maxsize=1)
def int_table() -> np.ndarray:
    """(262,) int32, the kernel's integer table: the PLFRAME length of
    each PLS (128); the transform's PLS (128, entry 4 j + 2 b + s of
    ``wht_table``); the PLSC scrambler's bits (2 words, bit k % 32 of word
    k // 32); the dummy PLS's bits (4 words)."""
    L = np.array([parse_pls(p).plframe_len for p in range(128)], np.uint32)
    wht = wht_table().reshape(-1).astype(np.uint32)

    def words(bits):
        b = np.asarray(bits, np.uint64).reshape(-1, 32)
        return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)

    dummy = [parse_pls(p).dummy_frame for p in range(128)]
    return np.concatenate([L, wht, words(PLSC_SCRAMBLER_BITS),
                           words(dummy)]).view(np.int32)


def _check_state(state, C):
    """The state leaves the kernel reads, checked and contiguous."""
    want = {k: ((C,), torch.int32) for k in INT_LEAVES}
    want.update(coarse_corrected=((C,), torch.bool),
                coarse_acc=((C, LAGS, 2), torch.float32),
                coarse_foffset=((C,), torch.float32))
    for name, (shape, dt) in want.items():
        x = state[name]
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: the kernel "
                             f"takes {shape} {dt}")
    return [state[k] for k in want]


def vcm_walk(state, search_mask, enabled_mask, K: int, F_pay: int,
             L_max: int, mode: str, coarse_period: int):
    """One launch of the chain walk and its books. ``state`` the VCM
    receiver's state as ``_step_a`` hands it over (symbuf (C, N_SYM, 2)
    float32, the ring; fp_right, symfill, pls, unlock_cnt, coarse_frames,
    settle (C,) int32; coarse_corrected (C,) bool; coarse_acc (C, 89, 2)
    and coarse_foffset (C,) float32); the search and output masks (128,)
    bool, True for the searched and the enabled PLS; K slots, F_pay lanes a
    channel; L_max the longest expected PLFRAME; ``mode`` the coherent
    PLSC mode; the coarse period in frames. Returns what
    ``VCMStreamReceiver._walk_books_plain`` returns."""
    symbuf = state["symbuf"]
    if symbuf.dtype != torch.float32 or symbuf.dim() != 3 \
            or symbuf.shape[2] != 2 or symbuf.shape[1] < WINDOW:
        raise ValueError(f"symbuf {tuple(symbuf.shape)} {symbuf.dtype}: the "
                         f"kernel takes (C, N_SYM >= {WINDOW}, 2) float32")
    C, n_sym = symbuf.shape[0], symbuf.shape[1]
    leaves = _check_state(state, C)
    for name, x in (("search_mask", search_mask),
                    ("enabled_mask", enabled_mask)):
        if x.dtype != torch.bool or tuple(x.shape) != (128,):
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: the kernel "
                             f"takes (128,) bool")
    ins = [symbuf, *leaves, search_mask, enabled_mask]
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("the walk's inputs must be contiguous")
    if mode not in MODES:
        raise ValueError(f"PLSC mode {mode!r}: the kernel takes {MODES}")
    if not (1 <= K <= MAX_K and 1 <= F_pay <= MAX_K and 0 < L_max):
        raise ValueError(f"K {K}, F_pay {F_pay} (1..{MAX_K}), L_max {L_max}")
    if not symbuf.is_cuda:
        raise ValueError("the kernel takes CUDA tensors; the plain version "
                         "is VCMStreamReceiver._walk_books_plain")
    dev = symbuf.device
    if any(x.device != dev for x in ins):
        raise ValueError("the walk's inputs must share one device")
    if symbuf.data_ptr() % 8:
        raise ValueError("symbuf must be 8-byte aligned")
    return _launch(symbuf, leaves, search_mask, enabled_mask, K, F_pay,
                   L_max, MODES.index(mode), int(coarse_period))


def _launch(symbuf, leaves, search_mask, enabled_mask, K, F_pay, L_max,
            mode, coarse_period):
    """``vcm_walk``'s launch on checked arguments."""
    global LAUNCHES
    C, n_sym, dev = symbuf.shape[0], symbuf.shape[1], symbuf.device
    ft = device_table(float_table(), dev)
    it = device_table(int_table(), dev)
    lut = device_table(plsync.plheader_conj_lut(), dev)

    # four allocations: the lanes' and carry's int64s, the int32s, the
    # floats (accumulator, estimate, metric sum, lane headers), the flags
    B = C * F_pay
    i64 = torch.empty(3 * B + 2 * C, dtype=torch.int64, device=dev)
    i32 = torch.empty((7, C), dtype=torch.int32, device=dev)
    f32 = torch.empty(C * LAGS * 2 + 2 * C + 2 * B * HEADER * 2,
                      dtype=torch.float32, device=dev)
    flags = torch.empty(B + 2 * C, dtype=torch.bool, device=dev)
    l_int = i64[: 3 * B].view(3, C, F_pay)
    carry = i64[3 * B:].view(2, C)
    acc = f32[: C * LAGS * 2].view(C, LAGS, 2)
    fl = f32[C * LAGS * 2: C * LAGS * 2 + 2 * C].view(2, C)
    hdrs = f32[C * LAGS * 2 + 2 * C:].view(2, C, F_pay, HEADER, 2)
    l_valid = flags[:B].view(C, F_pay)
    fo = flags[B:].view(2, C)
    fp_right, symfill, pls, unlock, frames, settle, corrected, acc_in, \
        foffset = leaves
    err = _build.lib().vcm_walk_launch(
        symbuf.data_ptr(), fp_right.data_ptr(), symfill.data_ptr(),
        pls.data_ptr(), corrected.data_ptr(), unlock.data_ptr(),
        acc_in.data_ptr(), frames.data_ptr(), settle.data_ptr(),
        foffset.data_ptr(), ft.data_ptr(), it.data_ptr(), lut.data_ptr(),
        search_mask.data_ptr(), enabled_mask.data_ptr(),
        l_int[0].data_ptr(), l_int[1].data_ptr(), l_int[2].data_ptr(),
        l_valid.data_ptr(), hdrs[0].data_ptr(), hdrs[1].data_ptr(),
        carry[0].data_ptr(), carry[1].data_ptr(), i32.data_ptr(),
        acc.data_ptr(), fl.data_ptr(), fo.data_ptr(), C, n_sym, K, F_pay,
        L_max, mode, coarse_period,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vcm_walk_kernel")
    LAUNCHES += 1
    key = (C, n_sym, K, F_pay)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    return {
        "lanes": {"pos": l_int[0], "pls": l_int[1], "next_pls": l_int[2],
                  "valid": l_valid, "own_hdr": hdrs[0], "next_hdr": hdrs[1]},
        "fp_right": carry[0], "pls": carry[1], "n_walked": i32[0],
        "unlock_cnt": i32[1], "coarse_frames": i32[2], "settle": i32[3],
        "counts": i32[4], "dummies": i32[5], "rejected": i32[6],
        "coarse_acc": acc, "coarse_foffset": fl[0], "metric_sum": fl[1],
        "coarse_corrected": fo[0], "new_coarse": fo[1],
    }
