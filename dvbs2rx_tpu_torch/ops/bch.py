"""Batched BCH decoder: syndrome matmul + Berlekamp-Massey + Chien search.

Port of ``dvbs2rx_tpu/ops/bch.py`` (reference ``lib/bch.cc:175-487``):

- syndromes as one GF(2) bit-plane matrix product ``(r @ A) mod 2``, a
  float32 ``torch.matmul`` with TF32 off (``utils.runtime.exact_fp32``):
  every sum is an integer below 2^24, so float32 is exact;
- batched Berlekamp-Massey over GF(2^m) with exp/log tables, 2t rounds;
- the Chien search of every bit position, and the correction.

On the card the last two are hand-written kernels (``ops/bch_cuda.py``,
``csrc/bch.cu``): one warp per frame runs the 2t rounds in registers, and
one block per frame evaluates the locator at every position in the log
domain and flips the roots. On the CPU they are the plain versions below:
the JAX module's loop (``berlekamp_massey_plain``) and its Chien product
with the bit-plane matrix ``T`` (``chien_matrix``, ``correct_plain``).
``T`` is large (((t+1)m, nbch*m): 431 MB in float32 for normal frames), so
the CPU builds it on the first frame that needs correcting; the card never
builds it.

A frame with more than t errors returns -1 corrections and its bits
unchanged, like the reference.

Two forms of each entry point. By default a batch whose frames are all
clean returns at once, which reads one flag back to the host. With
``sync_free=True`` the correction always runs: a clean frame keeps its bits
and gets 0 corrections, the device-side select of the JAX module's
``lax.cond`` (``dvbs2rx_tpu/ops/bch.py:189,221``). That form never waits on
the card, so a CUDA-graph capture can hold it and the shards of a mesh
queue without waiting on each other.
"""

import numpy as np
import torch

from ..spec import bch_spec
from ..utils.runtime import resolve_device
from . import bch_cuda


def chien_bit_matrix(exp_np, m, t, nbch, ordn):
    """T[i*m+l, e*m+k] = bit k of alpha^l * alpha^(-p_e * i), with
    p_e = nbch-1-e the polynomial power of bit position e (numpy int8)."""
    p = nbch - 1 - np.arange(nbch, dtype=np.int64)
    i = np.arange(t + 1, dtype=np.int64)
    l = np.arange(m, dtype=np.int64)
    T = np.empty(((t + 1) * m, nbch * m), np.int8)
    k = np.arange(m, dtype=np.int32)
    for s0 in range(0, nbch, 4096):
        pe = p[s0:s0 + 4096]
        expo = (l[None, :, None] - i[:, None, None] * pe[None, None, :])
        vals = exp_np[expo % ordn]
        bits = ((vals[..., None] >> k) & 1).astype(np.int8)
        T[:, s0 * m:(s0 + len(pe)) * m] = bits.reshape(
            (t + 1) * m, len(pe) * m
        )
    return T


def chien_matrix(exp16, t, nbch, ordn):
    """The plain Chien product's T (float32, on exp16's device) from the
    field's antilog table exp16 (``BCHDecoder._exp16``)."""
    exp_np = exp16.cpu().numpy().view(np.uint16)[:ordn].astype(np.int32)
    T = chien_bit_matrix(exp_np, ordn.bit_length(), t, nbch, ordn)
    return torch.as_tensor(T, device=exp16.device).to(torch.float32)


def _xor_reduce(x):
    """XOR of x (B, W) along its last axis, as a tree of halves over x
    zero-padded to a power of two: the running XOR's value in
    1 + ceil(log2 W) launches instead of W - 1."""
    w = 1 << (x.shape[1] - 1).bit_length()
    x = torch.nn.functional.pad(x, (0, w - x.shape[1]))
    while w > 1:
        w //= 2
        x = x[:, :w] ^ x[:, w:]
    return x[:, 0]


def _gf_mul(exp, log, a, b):
    res = exp[log[a] + log[b]]
    return torch.where((a == 0) | (b == 0), 0, res)


def _gf_inv(exp, log, a, ordn):
    return exp[(ordn - log[a]) % ordn]


def berlekamp_massey_plain(S, exp, log, t, ordn):
    """Plain version of the Berlekamp-Massey kernel, the JAX module's loop
    of 2t rounds of small batched operations: S (B, 2t) -> (sigma (B, t+1)
    coefficients, L (B,)); L > t flags an uncorrectable frame. exp and log
    are the field's tables, ordn = 2^m - 1."""
    B = S.shape[0]
    n_steps = 2 * t
    W = 2 * t + 1
    dev = S.device
    idx = torch.arange(W, device=dev)
    # C(x) = B(x) = 1: built by a comparison, not a write of a host
    # scalar (a host-to-device copy, which a CUDA-graph capture refuses)
    C = (idx == 0).to(torch.int64).expand(B, W).clone()
    Bp = C.clone()
    L = torch.zeros((B,), dtype=torch.int64, device=dev)
    m = torch.ones((B,), dtype=torch.int64, device=dev)
    b = torch.ones((B,), dtype=torch.int64, device=dev)
    for n in range(n_steps):
        s_idx = n - idx
        valid = (s_idx >= 0) & (s_idx < n_steps)
        s_val = torch.where(valid, S[:, s_idx.clamp(0, n_steps - 1)], 0)
        d = _xor_reduce(_gf_mul(exp, log, C, s_val))
        coef = _gf_mul(exp, log, d, _gf_inv(exp, log, b, ordn))
        roll_idx = idx[None, :] - m[:, None]
        shifted = torch.where(
            roll_idx >= 0,
            torch.gather(Bp, 1, roll_idx.clamp(0, W - 1)), 0,
        )
        C_new = C ^ _gf_mul(exp, log, coef[:, None], shifted)
        update = d != 0
        grow = update & (2 * L <= n)
        C_next = torch.where(update[:, None], C_new, C)
        Bp = torch.where(grow[:, None], C, Bp)
        L = torch.where(grow, n + 1 - L, L)
        b = torch.where(grow, d, b)
        m = torch.where(grow, 1, m + 1)
        C = C_next
    return C[:, : t + 1], L


def chien_plain(sigma, T, t):
    """The Chien product: sigma (B, t+1) -> (error mask (B, nbch) bool,
    n_roots (B,)), with T of ``chien_matrix``."""
    B = sigma.shape[0]
    m = T.shape[0] // (t + 1)
    k = torch.arange(m, device=sigma.device)
    sig_bits = ((sigma[:, :, None] >> k) & 1).reshape(
        B, (t + 1) * m).to(torch.float32)
    s = torch.matmul(sig_bits, T)                              # exact
    eval_bits = (s.to(torch.int64) & 1).reshape(B, -1, m)
    err = eval_bits.sum(-1) == 0
    return err, err.sum(1)


def correct_plain(bits, S, sigma, L, T, t):
    """Plain version of the Chien kernel: the Chien product and the masks
    (same contract as ``bch_cuda.chien_correct``)."""
    clean = (S == 0).all(dim=1)
    err_mask, n_roots = chien_plain(sigma, T, t)
    fail = (~clean) & ((L > t) | (n_roots != L))
    apply_mask = (~clean[:, None]) & (~fail[:, None]) & err_mask
    n_corr = torch.where(clean, 0, torch.where(fail, -1, n_roots))
    return bits ^ apply_mask.to(bits.dtype), n_corr.to(torch.int32)


class BCHDecoder:
    def __init__(self, framesize: str, t: int, nbch: int, kbch: int,
                 device=None):
        self.framesize = framesize
        self.t, self.nbch, self.kbch = t, nbch, kbch
        self.device = resolve_device(device)
        field = bch_spec.field_for(framesize)
        self.m = field.m
        self.ord = field.order - 1
        dev = self.device
        self._exp = torch.as_tensor(field.exp.astype(np.int64), device=dev)
        self._log = torch.as_tensor(field.log.astype(np.int64), device=dev)
        # the antilog table alpha^0 .. alpha^(ord-1) as 16-bit words,
        # zero-padded to whole 16-byte rows: the Chien kernel's, and what
        # the CPU builds T from
        e16 = np.zeros(-(-self.ord // 8) * 8, np.uint16)
        e16[: self.ord] = field.exp[: self.ord]
        self._exp16 = torch.as_tensor(e16.view(np.int16), device=dev)
        A = bch_spec.syndrome_bit_matrix(framesize, t, nbch)
        self._A = torch.as_tensor(A.astype(np.float32), device=dev)
        self._weights = torch.as_tensor(1 << np.arange(self.m), device=dev)
        self._T = None

    def _syndromes(self, bits):
        """bits (B, nbch) 0/1 -> syndromes (B, 2t) int64 GF elements."""
        s = torch.matmul(bits.to(torch.float32), self._A)      # exact
        s_bits = (s.to(torch.int64) & 1).reshape(-1, 2 * self.t, self.m)
        return (s_bits * self._weights).sum(-1)

    def chien_matrix(self):
        """The plain Chien product's T, built on first use (the CPU's
        path, and the card's only when a caller asks for it)."""
        if self._T is None:
            self._T = chien_matrix(self._exp16, self.t, self.nbch, self.ord)
        return self._T

    def _correct(self, bits, S):
        """Corrected bits and n_corr (B,) int32 of bits (B, nbch) with
        syndromes S: the kernels on the card, the plain versions on the
        CPU."""
        t, ordn = self.t, self.ord
        if bits.is_cuda:
            sigma, L = bch_cuda.berlekamp_massey(S, self._exp, self._log, t,
                                                 ordn)
            return bch_cuda.chien_correct(bits, S, sigma, L, self._exp16,
                                          self._log, t, self.nbch, ordn)
        sigma, L = berlekamp_massey_plain(S, self._exp, self._log, t, ordn)
        return correct_plain(bits, S, sigma, L, self.chien_matrix(), t)

    def decode_lane_major(self, bits_t, sync_free: bool = False):
        """bits_t (nbch, B) uint8 -> (corrected_t (nbch, B), n_corr (B,)).

        The all-frames-clean case (the common one after LDPC at operating
        SNR) returns at once; telling it apart reads one flag back to the
        host. ``sync_free=True`` always corrects and reads nothing back."""
        corrected, n_corr = self(bits_t.t(), sync_free)
        return corrected.t(), n_corr

    def __call__(self, bits, sync_free: bool = False):
        """bits (B, nbch) uint8 -> (corrected bits, n_corrections (B,)).
        ``sync_free`` as in ``decode_lane_major``."""
        B = bits.shape[0]
        S = self._syndromes(bits)
        if sync_free or not bool((S == 0).all()):
            return self._correct(bits, S)
        return bits, torch.zeros((B,), dtype=torch.int32, device=bits.device)

