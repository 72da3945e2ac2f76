"""Batched BCH decoder: syndrome matmul + Berlekamp-Massey + Chien search.

Port of ``dvbs2rx_tpu/ops/bch.py`` (reference ``lib/bch.cc:175-487``):

- syndromes as one GF(2) bit-plane matrix product ``(r @ A) mod 2``;
- batched Berlekamp-Massey over GF(2^m) with exp/log tables, 2t steps;
- Chien search as one product ``(sigma bits) @ T mod 2``.

The GF(2) products are float32 ``torch.matmul`` with TF32 off
(``utils.runtime.exact_fp32``): every sum is an integer below 2^24, so
float32 is exact. ``T`` is large (((t+1)m, nbch*m): 431 MB in float32 for
normal frames), so it is built on the first frame that needs correcting.

A frame with more than t errors returns -1 corrections and its bits
unchanged, like the reference.

Two forms of each entry point. By default a batch whose frames are all
clean returns at once, which reads one flag back to the host. With
``sync_free=True`` the correction always runs: its masks leave a clean
frame's bits untouched and give it 0 corrections, the device-side select
of the JAX module's ``lax.cond`` (``dvbs2rx_tpu/ops/bch.py:189,221``). That
form never waits on the card, so a CUDA-graph capture can hold it and the
shards of a mesh queue without waiting on each other; it pays for the
Chien product of every batch.
"""

import numpy as np
import torch

from ..spec import bch_spec
from ..utils.runtime import resolve_device


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


class BCHDecoder:
    def __init__(self, framesize: str, t: int, nbch: int, kbch: int,
                 device=None):
        self.framesize = framesize
        self.t, self.nbch, self.kbch = t, nbch, kbch
        self.device = resolve_device(device)
        field = bch_spec.field_for(framesize)
        self.m = field.m
        self.ord = field.order - 1
        self._exp_np = field.exp.astype(np.int32)
        dev = self.device
        self._exp = torch.as_tensor(field.exp.astype(np.int64), device=dev)
        self._log = torch.as_tensor(field.log.astype(np.int64), device=dev)
        A = bch_spec.syndrome_bit_matrix(framesize, t, nbch)
        self._A = torch.as_tensor(A.astype(np.float32), device=dev)
        self._weights = torch.as_tensor(1 << np.arange(self.m), device=dev)
        self._T = None

    # ---- GF helpers (batched) ----

    def _gf_mul(self, a, b):
        res = self._exp[self._log[a] + self._log[b]]
        return torch.where((a == 0) | (b == 0), 0, res)

    def _gf_inv(self, a):
        return self._exp[(self.ord - self._log[a]) % self.ord]

    # ---- stages ----

    def _syndromes(self, bits):
        """bits (B, nbch) 0/1 -> syndromes (B, 2t) int64 GF elements."""
        s = torch.matmul(bits.to(torch.float32), self._A)      # exact
        s_bits = (s.to(torch.int64) & 1).reshape(-1, 2 * self.t, self.m)
        return (s_bits * self._weights).sum(-1)

    def _berlekamp_massey(self, S):
        """S (B, 2t) -> (sigma (B, t+1) coefficients, L (B,)); L > t flags
        an uncorrectable frame."""
        B = S.shape[0]
        n_steps = 2 * self.t
        W = 2 * self.t + 1
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
            d = _xor_reduce(self._gf_mul(C, s_val))
            coef = self._gf_mul(d, self._gf_inv(b))
            roll_idx = idx[None, :] - m[:, None]
            shifted = torch.where(
                roll_idx >= 0,
                torch.gather(Bp, 1, roll_idx.clamp(0, W - 1)), 0,
            )
            C_new = C ^ self._gf_mul(coef[:, None], shifted)
            update = d != 0
            grow = update & (2 * L <= n)
            C_next = torch.where(update[:, None], C_new, C)
            Bp = torch.where(grow[:, None], C, Bp)
            L = torch.where(grow, n + 1 - L, L)
            b = torch.where(grow, d, b)
            m = torch.where(grow, 1, m + 1)
            C = C_next
        return C[:, : self.t + 1], L

    def _chien(self, sigma):
        """sigma (B, t+1) -> (error mask (B, nbch) bool, n_roots (B,))."""
        if self._T is None:
            T = chien_bit_matrix(self._exp_np, self.m, self.t, self.nbch,
                                 self.ord)
            self._T = torch.as_tensor(T, device=self.device).to(torch.float32)
        B, m = sigma.shape[0], self.m
        k = torch.arange(m, device=sigma.device)
        sig_bits = ((sigma[:, :, None] >> k) & 1).reshape(
            B, (self.t + 1) * m).to(torch.float32)
        s = torch.matmul(sig_bits, self._T)                    # exact
        eval_bits = (s.to(torch.int64) & 1).reshape(B, self.nbch, m)
        err = eval_bits.sum(-1) == 0
        return err, err.sum(1)

    def _correct(self, S):
        """Error mask (B, nbch) and n_corr (B,) int32 for syndromes S."""
        clean = (S == 0).all(dim=1)
        sigma, L = self._berlekamp_massey(S)
        err_mask, n_roots = self._chien(sigma)
        fail = (~clean) & ((L > self.t) | (n_roots != L))
        apply_mask = (~clean[:, None]) & (~fail[:, None]) & err_mask
        n_corr = torch.where(clean, 0, torch.where(fail, -1, n_roots))
        return apply_mask, n_corr.to(torch.int32)

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
            mask, n_corr = self._correct(S)
            return bits ^ mask.to(bits.dtype), n_corr
        return bits, torch.zeros((B,), dtype=torch.int32, device=bits.device)

