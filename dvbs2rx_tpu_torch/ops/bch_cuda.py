"""The BCH decoder's two CUDA kernels: the locator (hard bits -> syndromes,
Berlekamp-Massey) and the Chien search.

The JAX ``BCHDecoder`` (``dvbs2rx_tpu/ops/bch.py:84-187``) runs the decode
as XLA code, with no Pallas kernel: the syndrome product with the bit-plane
matrix ``A``, a ``lax.fori_loop`` of 2t rounds, then one product of the
locator's bits with a ((t+1)m, nbch*m) bit-plane matrix ``T`` and the
correction masks. The port's plain versions are those steps in PyTorch
(``locator_plain``, ``chien_matrix`` and ``correct_plain`` in
``ops/bch.py``). ``csrc/bch.cu`` holds the two kernels that take their
place on the card; its source note says how each is laid out and what
bounds it. Both give the plain versions' integers bit for bit,
uncorrectable frames included, and need neither ``A`` nor ``T``.

Neither wrapper reads anything back or copies from the host, so a CUDA
graph capture holds them (``StreamReceiver.make_scan_step``). The locator
sums a frame group's syndromes across blocks in a scratch buffer that its
caller owns (``new_scratch``; ``BCHDecoder`` keeps one per batch size) and
the kernel returns to zero, so a replay finds it ready; one scratch must
not serve two locators running at once.

The wrappers take tensors and integers only (``BCHDecoder.locator`` and
``correct`` pass its tables). Dispatch is by the tensor's device: CPU
tensors take the plain versions; CUDA tensors launch the kernel or raise.
"""

import functools

import torch

from .. import _build

# kernel launches by kernel; incremented only where a kernel runs
LAUNCHES = {"bch_locator": 0, "bch_chien": 0}
LAUNCH_SHAPES = {}  # the same launches by (kernel, t, nbch, ord, B)


def _reset_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def _count(kernel, t, nbch, ordn, B):
    LAUNCHES[kernel] += 1
    key = (kernel, t, nbch, ordn, B)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


for _k in LAUNCHES:
    _build.register_counter(_k, lambda k=_k: LAUNCHES[k], _reset_counts)

T_VALUES = (8, 10, 12)  # the locator kernel's instantiations (DVB-S2 codes)
MAX_T = 12              # kMaxT of csrc/bch.cu
MAX_ORD = 65535         # kMaxOrd: GF(2^16)
LOCATOR_WARPS = 8       # kLocWarps: a block's warps share its positions
STAGE_QUADS = 256       # kStageQuads: quads of positions staged at a time
CHIEN_THREADS = 512     # kChienThreads: a thread's two positions are this
                        # apart, and it steps by twice this
GROUP = 32              # frames per locator warp, one per lane



def _check(x, name, dtype, shape, device):
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, not {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} of shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")


def _check_code(t, ordn, nbch=0):
    if not 1 <= t <= MAX_T or not 2 ** 14 - 1 <= ordn <= MAX_ORD \
            or ordn & (ordn + 1) or nbch > ordn:
        raise ValueError(f"t = {t}, field order {ordn + 1}, nbch {nbch}: "
                         f"the kernels take t <= {MAX_T} and 14 <= m <= 16")


def locator_plan(B, nbch, n_sm):
    """The locator's grid: (frame groups of 32, position chunks per group).
    One block per multiprocessor (its shared tables take most of one), the
    chunks in whole quads of positions (nbch/4 of them), at least one quad
    per warp. Block c of a group takes the quads [c Q / chunks, (c+1) Q /
    chunks), Q = nbch/4, STAGE_QUADS at a time in two halves, and its
    LOCATOR_WARPS warps split each half in pairs of positions."""
    groups = -(-B // GROUP)
    quads = nbch // 4
    return groups, max(1, min(n_sm // groups, quads // LOCATOR_WARPS))


def new_scratch(B, t, device):
    """The locator's scratch for batches of B frames: zeros for its
    accumulators (32-frame groups x 32 x the odd-power table's words) and
    its arrival counters (one a group). Allocate it outside any graph
    capture and keep it while a captured graph holds its pointer."""
    from .bch import odd_words

    groups = -(-B // GROUP)
    return torch.zeros(groups * GROUP * odd_words(t) + groups,
                       dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def locator(bits, odd, exp16, log16, zech16, scratch, t, nbch, ordn):
    """Syndromes and error locators of a batch: bits (B, nbch) uint8 0/1
    (any strides; the lane-major decode passes the transpose of an (nbch,
    B) tensor) -> (S (B, 2t), sigma (B, t+1) coefficients sigma_0..sigma_t,
    L (B,)), all int64; L > t flags an uncorrectable frame. exp16 is the
    field's antilog table alpha^0..alpha^(ordn-1) and log16 its log table
    (log16[0] = 0xFFFF) as int16 words, each zero-padded to a multiple of
    8; odd (the (nbch, words) int32 table of odd powers,
    ``bch.odd_power_table``), zech16 (``bch.zech_table``) and scratch
    (``new_scratch(B, t)``) are the kernel's own, unused on the CPU."""
    B, dev = bits.shape[0], bits.device
    _check(bits, "bits", torch.uint8, (B, nbch), dev)
    _check(exp16, "exp16", torch.int16, (-(-ordn // 8) * 8,), dev)
    _check(log16, "log16", torch.int16, (-(-(ordn + 1) // 8) * 8,), dev)
    if not bits.is_cuda:
        from .bch import field_tables, locator_plain, syndrome_matrix

        exp, log = field_tables(exp16, log16, ordn)
        return locator_plain(bits, syndrome_matrix(exp16, t, nbch, ordn),
                             exp, log, t, ordn)
    from .bch import odd_words

    _check_code(t, ordn, nbch)
    if t not in T_VALUES or nbch % 4:
        raise ValueError(f"t = {t}, nbch = {nbch}: the locator kernel takes "
                         f"t in {T_VALUES} and nbch a multiple of 4")
    _check(odd, "odd", torch.int32, (nbch, odd_words(t)), dev)
    _check(zech16, "zech16", torch.int16, tuple(log16.shape), dev)
    groups = -(-B // GROUP)
    _check(scratch, "scratch", torch.int32,
           (groups * GROUP * odd_words(t) + groups,), dev)
    if not (odd.is_contiguous() and exp16.is_contiguous()
            and log16.is_contiguous() and zech16.is_contiguous()):
        raise ValueError("the tables must be contiguous")
    S = torch.empty((B, 2 * t), dtype=torch.int64, device=dev)
    sigma = torch.empty((B, t + 1), dtype=torch.int64, device=dev)
    L = torch.empty((B,), dtype=torch.int64, device=dev)
    if B == 0:
        return S, sigma, L
    _, chunks = locator_plan(B, nbch, _n_sm(dev))
    _launch_locator(_build.lib(), bits, odd, exp16, log16, zech16, S, sigma,
                    L, scratch, t, nbch, ordn, chunks)
    _count("bch_locator", t, nbch, ordn, B)
    return S, sigma, L


def _launch_locator(lib, bits, odd, exp16, log16, zech16, S, sigma, L,
                    scratch, t, nbch, ordn, chunks):
    """One launch of ``lib``'s locator kernel (the package's library, or a
    variant's in ``tools/torch_bch_variants.py``)."""
    sb, se = bits.stride()
    err = lib.bch_locator_launch(
        bits.data_ptr(), odd.data_ptr(), exp16.data_ptr(), log16.data_ptr(),
        zech16.data_ptr(), S.data_ptr(), sigma.data_ptr(), L.data_ptr(),
        scratch.data_ptr(), sb, se, bits.shape[0], t, nbch, ordn, chunks,
        torch.cuda.current_stream(bits.device).cuda_stream)
    _build.check(err, "bch_locator_kernel")


def chien_correct(bits, S, sigma, L, exp16, log, t, nbch, ordn):
    """Correct a batch: bits (B, nbch) uint8 0/1 (any strides; the
    lane-major decode passes the transpose of an (nbch, B) tensor), its
    syndromes S (B, 2t), and the locators (sigma, L) of ``locator``;
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
    _launch_chien(_build.lib(), S, sigma, L, exp16, log, out, n_corr, t,
                  nbch, ordn)
    _count("bch_chien", t, nbch, ordn, B)
    return out, n_corr


def _launch_chien(lib, S, sigma, L, exp16, log, out, n_corr, t, nbch, ordn):
    """One launch of ``lib``'s Chien kernel on ``out`` in place."""
    sb, se = out.stride()
    err = lib.bch_chien_launch(
        S.data_ptr(), sigma.data_ptr(), L.data_ptr(), exp16.data_ptr(),
        log.data_ptr(), out.data_ptr(), sb, se, n_corr.data_ptr(),
        out.shape[0], t, nbch, ordn,
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "bch_chien_kernel")
