"""Batched BCH decoder: syndromes + Berlekamp-Massey + Chien search.

Port of ``dvbs2rx_tpu/ops/bch.py`` (reference ``lib/bch.cc:175-487``):

- the 2t syndromes S_j = r(alpha^j) of the hard bits r;
- batched Berlekamp-Massey over GF(2^m) with exp/log tables, 2t rounds;
- the Chien search of every bit position, and the correction.

On the card the decode is two hand-written kernels (``ops/bch_cuda.py``,
``csrc/bch.cu``): the locator kernel goes from the hard bits to (S, sigma,
L), each lane summing one frame's odd syndromes over a share of the
positions from the decoder's table of odd powers (``odd_power_table``), the
even ones by squaring, and the last block of a frame group running the 2t
rounds; the Chien kernel evaluates the locator at every position in the
log domain and flips the roots. On the CPU they are the plain versions
below: the JAX module's GF(2) bit-plane product ``(r @ A) mod 2`` (a
float32 ``torch.matmul`` with TF32 off, ``utils.runtime.exact_fp32``: every
sum is an integer below 2^24, so float32 is exact), its loop
(``berlekamp_massey_plain``; the two as one function, ``locator_plain``)
and its Chien product with the bit-plane matrix ``T`` (``chien_matrix``,
``correct_plain``). ``A`` ((nbch, 2tm): 49.8 MB in float32 for normal 1/2)
and ``T`` (((t+1)m, nbch*m): 431 MB) are built on their first plain use, so
never by the card's decode.

A frame with more than t errors returns -1 corrections and its bits
unchanged, like the reference.

Two forms of each entry point. By default a batch whose frames are all
clean returns after the syndromes, which reads one flag back to the host.
With ``sync_free=True`` the correction always runs: a clean frame keeps its
bits and gets 0 corrections, the device-side select of the JAX module's
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


def _exp_np(exp16, ordn):
    return exp16.cpu().numpy().view(np.uint16)[:ordn].astype(np.int64)


def chien_matrix(exp16, t, nbch, ordn):
    """The plain Chien product's T (float32, on exp16's device) from the
    field's antilog table exp16 (``BCHDecoder._exp16``)."""
    T = chien_bit_matrix(_exp_np(exp16, ordn), ordn.bit_length(), t, nbch,
                         ordn)
    return torch.as_tensor(T, device=exp16.device).to(torch.float32)


def syndrome_matrix(exp16, t, nbch, ordn):
    """The plain syndrome product's A (float32, on exp16's device):
    A[e, (j-1)m + k] = bit k of alpha^(j p_e), j = 1..2t, p_e = nbch-1-e
    the polynomial power of bit position e (``bch_spec.
    syndrome_bit_matrix`` from the antilog table)."""
    exp_np = _exp_np(exp16, ordn)
    m = ordn.bit_length()
    p = nbch - 1 - np.arange(nbch, dtype=np.int64)
    A = np.empty((nbch, 2 * t, m), np.float32)
    for j in range(1, 2 * t + 1):
        vals = exp_np[(j * p) % ordn]
        A[:, j - 1] = (vals[:, None] >> np.arange(m)) & 1
    return torch.as_tensor(A.reshape(nbch, 2 * t * m), device=exp16.device)


def odd_words(t):
    """int32 words per position of ``odd_power_table``: t/2 pairs of odd
    syndromes, rounded up to an even count (the kernel reads 8-byte
    pairs)."""
    return -(-t // 4) * 2


def odd_power_table(exp16, t, nbch, ordn):
    """The locator kernel's syndrome table (int32, on exp16's device): row
    e holds alpha^(j p_e) for the odd j = 1, 3, ..., 2t-1, two per word
    (word w: j = 4w+1 in the low 16 bits, j = 4w+3 in the high ones),
    zero-padded to ``odd_words(t)`` words. S_j of a frame is the XOR of
    the rows of its set bits; the even S_2j = S_j^2 need no row."""
    exp_np = _exp_np(exp16, ordn)
    p = nbch - 1 - np.arange(nbch, dtype=np.int64)
    half = np.zeros((nbch, 2 * odd_words(t)), np.uint32)
    for k in range(t):
        half[:, k] = exp_np[((2 * k + 1) * p) % ordn]
    words = half[:, 0::2] | (half[:, 1::2] << 16)
    return torch.as_tensor(words.view(np.int32), device=exp16.device)


def zech_table(exp16, log16, ordn):
    """The locator kernel's Zech table (int16, on exp16's device): entry k
    < ord is log(1 + alpha^k), so log(a + b) = log a + Z(log b - log a);
    entry 0 (a = b, a sum of 0, which the kernel tells apart) holds 0xFFFF
    and entry ord 0 (a zero term, whose log difference the kernel clamps
    there, leaves the other)."""
    exp_np = _exp_np(exp16, ordn)
    log_np = log16.cpu().numpy().view(np.uint16).astype(np.int64)
    z = np.zeros(-(-(ordn + 1) // 8) * 8, np.uint16)
    z[0] = 0xFFFF
    z[1:ordn] = log_np[1 ^ exp_np[1:ordn]]
    return torch.as_tensor(z.view(np.int16), device=exp16.device)


def field_tables(exp16, log16, ordn):
    """The plain versions' int64 tables from the kernels' 16-bit ones: exp
    (2 ordn,) indexed by log a + log b unreduced, log (ordn + 1,) with
    log[0] = 0 (``GF2m``)."""
    e = exp16[:ordn].to(torch.int64) & 0xFFFF
    log = log16.to(torch.int64) & 0xFFFF
    log[0] = 0
    return torch.cat([e, e]), log


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


def syndromes_plain(bits, A, t, ordn):
    """The syndrome product: bits (B, nbch) uint8 -> S (B, 2t) int64 GF
    elements, with A of ``syndrome_matrix``."""
    m = ordn.bit_length()
    s = torch.matmul(bits.to(torch.float32), A)                # exact
    s_bits = (s.to(torch.int64) & 1).reshape(-1, 2 * t, m)
    w = 1 << torch.arange(m, device=bits.device)
    return (s_bits * w).sum(-1)


def locator_plain(bits, A, exp, log, t, ordn):
    """Plain version of the locator kernel: the syndrome product, then the
    Berlekamp-Massey loop: bits (B, nbch) uint8 -> (S (B, 2t), sigma (B,
    t+1) contiguous, L (B,)), all int64 (same contract as
    ``bch_cuda.locator``)."""
    S = syndromes_plain(bits, A, t, ordn)
    sigma, L = berlekamp_massey_plain(S, exp, log, t, ordn)
    return S, sigma.contiguous(), L


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
        # the antilog table alpha^0 .. alpha^(ord-1) and the log table as
        # 16-bit words, zero-padded to whole 16-byte rows (entry ord of
        # exp16 is 0; log16[0] = 0xFFFF marks log 0): the kernels' tables,
        # and what the plain versions' A and T are built from
        e16 = np.zeros(-(-self.ord // 8) * 8, np.uint16)
        e16[: self.ord] = field.exp[: self.ord]
        self._exp16 = torch.as_tensor(e16.view(np.int16), device=dev)
        l16 = np.zeros(-(-(self.ord + 1) // 8) * 8, np.uint16)
        l16[: self.ord + 1] = field.log
        l16[0] = 0xFFFF
        self._log16 = torch.as_tensor(l16.view(np.int16), device=dev)
        # the locator kernel's tables (the CPU's plain version needs neither)
        self._odd = self._zech16 = None
        if self.device.type == "cuda":
            self._odd = odd_power_table(self._exp16, t, nbch, self.ord)
            self._zech16 = zech_table(self._exp16, self._log16, self.ord)
        self._A_mat = None
        self._T = None
        self._scratch = {}      # the locator's, by batch size

    def syndrome_matrix(self):
        """The plain syndrome product's A, built on first use (the CPU's
        path, and the card's only when a caller asks for it)."""
        if self._A_mat is None:
            self._A_mat = syndrome_matrix(self._exp16, self.t, self.nbch,
                                          self.ord)
        return self._A_mat

    def chien_matrix(self):
        """The plain Chien product's T, built on first use (the CPU's
        path, and the card's only when a caller asks for it)."""
        if self._T is None:
            self._T = chien_matrix(self._exp16, self.t, self.nbch, self.ord)
        return self._T

    def _syndromes(self, bits):
        """bits (B, nbch) 0/1 -> syndromes (B, 2t) int64 GF elements, by
        the plain product."""
        return syndromes_plain(bits, self.syndrome_matrix(), self.t,
                               self.ord)

    def locator(self, bits):
        """(S (B, 2t), sigma (B, t+1), L (B,)) int64 of bits (B, nbch)
        uint8: the locator kernel on the card, the plain version on the
        CPU."""
        if bits.is_cuda:
            B = bits.shape[0]
            if B not in self._scratch:
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError("BCHDecoder: the first call of a batch "
                                       "size must come before a graph "
                                       "capture")
                self._scratch[B] = bch_cuda.new_scratch(B, self.t,
                                                        self.device)
            return bch_cuda.locator(bits, self._odd, self._exp16,
                                    self._log16, self._zech16,
                                    self._scratch[B], self.t, self.nbch,
                                    self.ord)
        return locator_plain(bits, self.syndrome_matrix(), self._exp,
                             self._log, self.t, self.ord)

    def correct(self, bits, S, sigma, L):
        """Corrected bits and n_corr (B,) int32 of bits (B, nbch) with
        their locators: the Chien kernel on the card, the plain version
        on the CPU."""
        if bits.is_cuda:
            return bch_cuda.chien_correct(bits, S, sigma, L, self._exp16,
                                          self._log, self.t, self.nbch,
                                          self.ord)
        return correct_plain(bits, S, sigma, L, self.chien_matrix(), self.t)

    def decode_lane_major(self, bits_t, sync_free: bool = False):
        """bits_t (nbch, B) uint8 -> (corrected_t (nbch, B), n_corr (B,)).

        The all-frames-clean case (the common one after LDPC at operating
        SNR) returns after the syndromes; telling it apart reads one flag
        back to the host. ``sync_free=True`` always corrects and reads
        nothing back."""
        corrected, n_corr = self(bits_t.t(), sync_free)
        return corrected.t(), n_corr

    def __call__(self, bits, sync_free: bool = False):
        """bits (B, nbch) uint8 -> (corrected bits, n_corrections (B,)).
        ``sync_free`` as in ``decode_lane_major``. On the card the locator
        kernel runs first and the Chien kernel after it (always with
        ``sync_free``); on the CPU Berlekamp-Massey runs only when a frame
        needs it."""
        B = bits.shape[0]
        if bits.is_cuda:
            S, sigma, L = self.locator(bits)
            if sync_free or not bool((S == 0).all()):
                return self.correct(bits, S, sigma, L)
        else:
            S = self._syndromes(bits)
            if sync_free or not bool((S == 0).all()):
                sigma, L = berlekamp_massey_plain(S, self._exp, self._log,
                                                  self.t, self.ord)
                return self.correct(bits, S, sigma.contiguous(), L)
        return bits, torch.zeros((B,), dtype=torch.int32, device=bits.device)
