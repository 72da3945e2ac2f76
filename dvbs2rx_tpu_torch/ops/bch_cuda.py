"""Berlekamp-Massey and the Chien search of the BCH decoder through CUDA
kernels.

The JAX ``BCHDecoder`` (``dvbs2rx_tpu/ops/bch.py:96-187``) runs both as XLA
code, with no Pallas kernel: a ``lax.fori_loop`` of 2t rounds, then one
product of the locator's bits with a ((t+1)m, nbch*m) bit-plane matrix
``T`` and the correction masks. The port's plain versions are those steps
in PyTorch (``berlekamp_massey_plain``, ``chien_matrix`` and
``correct_plain`` in ``ops/bch.py``). ``csrc/bch.cu`` holds the two
kernels that take their place on the card; its source note says how each
is laid out and what bounds it. Both give the plain versions' integers bit
for bit, uncorrectable frames included, and the Chien kernel needs no
``T``.

Neither wrapper reads anything back or copies from the host, so a CUDA
graph capture holds them (``StreamReceiver.make_scan_step``).

The wrappers take tensors and integers only (``BCHDecoder._correct``
passes its tables). Dispatch is by the tensor's device: CPU tensors take
the plain versions; CUDA tensors launch the kernel or raise.
"""

import torch

from .. import _build

# kernel launches by kernel; incremented only where a kernel runs
LAUNCHES = {"bch_berlekamp_massey": 0, "bch_chien": 0}


def _reset_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


for _k in LAUNCHES:
    _build.register_counter(_k, lambda k=_k: LAUNCHES[k], _reset_counts)

MAX_T = 12          # kMaxT of csrc/bch.cu
MAX_ORD = 65535     # kMaxOrd: GF(2^16)
CHIEN_THREADS = 1024    # kChienThreads: a thread's positions are this apart


def _check(x, name, dtype, shape, device):
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, not {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} of shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")


def _check_code(t, ordn, nbch=0):
    if not 1 <= t <= MAX_T or not t * CHIEN_THREADS < ordn <= MAX_ORD \
            or nbch > ordn:
        raise ValueError(f"t = {t}, field order {ordn + 1}, nbch {nbch}: "
                         f"the kernels take t <= {MAX_T} and 14 <= m <= 16")


def berlekamp_massey(S, exp, log, t, ordn):
    """Error locators of a batch: S (B, 2t) int64 syndromes over GF(2^m),
    ordn = 2^m - 1, with the field's exp (2 ordn,) and log (ordn + 1,)
    int64 tables -> (sigma (B, t+1) int64 coefficients sigma_0..sigma_t,
    L (B,) int64); L > t flags an uncorrectable frame."""
    B, dev = S.shape[0], S.device
    _check(S, "S", torch.int64, (B, 2 * t), dev)
    _check(exp, "exp", torch.int64, (2 * ordn,), dev)
    _check(log, "log", torch.int64, (ordn + 1,), dev)
    if not S.is_cuda:
        from .bch import berlekamp_massey_plain

        return berlekamp_massey_plain(S, exp, log, t, ordn)
    _check_code(t, ordn)
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    sigma = torch.empty((B, t + 1), dtype=torch.int64, device=dev)
    L = torch.empty((B,), dtype=torch.int64, device=dev)
    if B == 0:
        return sigma, L
    err = _build.lib().bch_berlekamp_massey_launch(
        S.data_ptr(), exp.data_ptr(), log.data_ptr(), sigma.data_ptr(),
        L.data_ptr(), B, t, ordn, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bch_berlekamp_massey_kernel")
    LAUNCHES["bch_berlekamp_massey"] += 1
    return sigma, L


def chien_correct(bits, S, sigma, L, exp16, log, t, nbch, ordn):
    """Correct a batch: bits (B, nbch) uint8 0/1 (any strides; the
    lane-major decode passes the transpose of an (nbch, B) tensor), its
    syndromes S (B, 2t), and the locators (sigma, L) of ``berlekamp_massey``;
    exp16 the field's antilog table alpha^0..alpha^(ordn-1) as int16 words,
    zero-padded to a multiple of 8, and log its (ordn + 1,) int64 log table
    -> (corrected bits, n_corr (B,) int32). n_corr is 0 for a clean frame,
    -1 for a frame that fails (L > t, or a root count other than L), whose
    bits stay as they were, and the number of corrected bits otherwise."""
    B, dev = bits.shape[0], bits.device
    _check(bits, "bits", torch.uint8, (B, nbch), dev)
    _check(S, "S", torch.int64, (B, 2 * t), dev)
    _check(sigma, "sigma", torch.int64, (B, t + 1), dev)
    _check(L, "L", torch.int64, (B,), dev)
    _check(exp16, "exp16", torch.int16, (-(-ordn // 8) * 8,), dev)
    _check(log, "log", torch.int64, (ordn + 1,), dev)
    if not bits.is_cuda:
        from .bch import chien_matrix, correct_plain

        return correct_plain(bits, S, sigma, L,
                             chien_matrix(exp16, t, nbch, ordn), t)
    _check_code(t, ordn, nbch)
    if not (S.is_contiguous() and sigma.is_contiguous()
            and L.is_contiguous()):
        raise ValueError("S, sigma and L must be contiguous")
    out = bits.clone()          # a dense layout keeps its strides
    n_corr = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, n_corr
    sb, se = out.stride()
    err = _build.lib().bch_chien_launch(
        S.data_ptr(), sigma.data_ptr(), L.data_ptr(), exp16.data_ptr(),
        log.data_ptr(), out.data_ptr(), sb, se, n_corr.data_ptr(), B, t,
        nbch, ordn, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bch_chien_kernel")
    LAUNCHES["bch_chien"] += 1
    return out, n_corr
