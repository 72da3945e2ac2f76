"""The FEC tail's plain versions against the JAX package, bit for bit, and
the arithmetic of their CUDA kernels mirrored in numpy.

On the CPU the port's ``BCHDecoder`` runs its plain syndrome product,
Berlekamp-Massey loop and Chien product (``ops/bch.py``; the wrappers of
``ops/bch_cuda.py`` take them for CPU tensors too), and ``packet_validity``
its plain prefix scan (``ops/crc8_cuda.py``). These tests hold them to
``dvbs2rx_tpu/ops/bch.py`` and ``crc8_dev.py``:

- Berlekamp-Massey alone at t = 8, 10, 12 in GF(2^14) and GF(2^16), on
  random syndromes and on the syndromes of 0..2t+3 errors (an error at bit
  power p adds alpha^(jp) to S_j): sigma and L equal, uncorrectable
  frames included;
- the whole decoder on short frames (B = 16: 0, 1..t, t+1..2t+3 errors,
  some in the parity bits only; and an all-clean batch) in both forms, and
  one normal-frame decoder (1/4, m = 16) at B = 4;
- ``packet_validity`` on Tx BBFRAMEs at n = 879, 4,026, 4,836 and on random
  bytes at n = 883 (no n is a multiple of 8), and against its definition
  ``ok[p] = crc8(bytes[max(0, p-187):p]) == bytes[p]``.

Exact throughout: every output is an integer. The kernels cannot run here
(no nvcc, no card), so the numpy mirrors below repeat what they compute
(the scan of run CRCs of ``csrc/crc8.cu``; the locator kernel's
syndrome stage, chunked and staged as the kernel splits the positions,
and its Berlekamp-Massey rounds in the log domain with the Zech table; the
log-domain Chien evaluation of ``csrc/bch.cu``) against the plain versions
and JAX; the wrappers on CPU tensors take the plain version, launch
nothing, and importing them builds nothing. The on-card tier is
``tests/test_torch_cuda.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvbs2rx_tpu.ops import bch as jbch
from dvbs2rx_tpu.ops import crc8_dev as jcrc
from dvbs2rx_tpu.spec import bch_spec as jbch_spec
from dvbs2rx_tpu.tx import Transmitter, TxConfig

from dvbs2rx_tpu_torch import _build
from dvbs2rx_tpu_torch.ops import bch, bch_cuda, crc8_cuda, crc8_dev
from dvbs2rx_tpu_torch.spec import bch_spec
from dvbs2rx_tpu_torch.spec.scramblers import crc8_table

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
SHORT = ("short", 12, 7200, 7032)
NORMAL_1_4 = ("normal", 12, 16200, 16008)
# (frame size, t, nbch, kbch) of the locator mirrors: short 1/2, normal
# 1/2 (t = 12), 2/3 (t = 10) and 8/9 (t = 8)
LOCATOR_CODES = {
    "short_1_2": ("short", 12, 7200, 7032),
    "normal_1_2": ("normal", 12, 32400, 32208),
    "normal_2_3": ("normal", 10, 43200, 43040),
    "normal_8_9": ("normal", 8, 57600, 57472),
}


def _gf_pair(framesize, t):
    """The JAX and the port's decoder with only their GF tables set (the
    Berlekamp-Massey loop needs no code matrix): any t in either field."""
    field = bch_spec.field_for(framesize)
    jf = jbch_spec.field_for(framesize)
    j = object.__new__(jbch.BCHDecoder)
    j.t, j.ord = t, jf.order - 1
    j._exp_np, j._log_np = jf.exp.astype(np.int32), jf.log.astype(np.int32)
    p = object.__new__(bch.BCHDecoder)
    p.t, p.m, p.ord = t, field.m, field.order - 1
    p._exp = torch.as_tensor(field.exp.astype(np.int64))
    p._log = torch.as_tensor(field.log.astype(np.int64))
    return j, p


def _error_syndromes(field, t, n_errs, nbch, rng):
    """(len(n_errs), 2t) syndromes of error patterns: S_j = sum over the
    errors' bit powers p of alpha^((j+1) p)."""
    ordn = field.order - 1
    S = np.zeros((len(n_errs), 2 * t), np.int64)
    j = np.arange(1, 2 * t + 1)
    for b, k in enumerate(n_errs):
        for p in rng.choice(nbch, k, replace=False):
            S[b] ^= field.exp[(j * int(p)) % ordn]
    return S


@pytest.mark.parametrize("framesize", ["short", "normal"])
def test_berlekamp_massey_matches_jax(framesize):
    rng = np.random.default_rng(7)
    for t in (8, 10, 12):
        jdec, dec = _gf_pair(framesize, t)
        nbch = 7200 if framesize == "short" else 57600
        real = _error_syndromes(bch_spec.field_for(framesize), t,
                                np.arange(2 * t + 4), nbch, rng)
        rand = rng.integers(0, dec.ord + 1, (12, 2 * t))
        S = np.concatenate([real, rand, np.zeros((1, 2 * t), np.int64)])
        sig, L = bch.berlekamp_massey_plain(torch.from_numpy(S), dec._exp,
                                            dec._log, t, dec.ord)
        jsig, jL = jdec._berlekamp_massey(jnp.asarray(S, jnp.int32))
        np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
        np.testing.assert_array_equal(L.numpy(), np.asarray(jL))
        # up to t errors the locator has one root per error
        np.testing.assert_array_equal(L.numpy()[: t + 1], np.arange(t + 1))


def _codewords(code, n_errs, rng, parity_only=()):
    framesize, t, nbch, kbch = code
    out = []
    for b, k in enumerate(n_errs):
        msg = rng.integers(0, 256, kbch // 8, dtype=np.uint8)
        par = bch_spec.bch_encode_bytes(msg, framesize, t)
        bits = np.concatenate([np.unpackbits(msg), np.unpackbits(par)])
        lo = kbch if b in parity_only else 0
        bits[lo + rng.choice(nbch - lo, k, replace=False)] ^= 1
        out.append(bits)
    return np.stack(out)


@pytest.fixture(scope="module")
def short_pair():
    return jbch.BCHDecoder(*SHORT), bch.BCHDecoder(*SHORT, device="cpu")


@pytest.mark.parametrize("sync_free", [False, True])
def test_short_decoder_matches_jax_on_every_error_pattern(short_pair,
                                                          sync_free):
    jdec, dec = short_pair
    rng = np.random.default_rng(11)
    n_errs = [0, 1, 2, 5, 12, 12, 11, 13, 14, 20, 27, 0, 3, 7, 25, 26]
    bits = _codewords(SHORT, n_errs, rng, parity_only=(5, 6, 12))
    bits_t = np.ascontiguousarray(bits.T)
    want_t, want_n = jdec.decode_lane_major(jnp.asarray(bits_t))
    got_t, got_n = dec.decode_lane_major(torch.from_numpy(bits_t), sync_free)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(
        got_n.numpy(), [k if k <= 12 else -1 for k in n_errs])
    got, n = dec(torch.from_numpy(bits), sync_free)
    np.testing.assert_array_equal(got.numpy(), got_t.numpy().T)
    np.testing.assert_array_equal(n.numpy(), got_n.numpy())
    clean = _codewords(SHORT, [0] * 4, rng)
    got, n = dec(torch.from_numpy(clean), sync_free)
    np.testing.assert_array_equal(got.numpy(), clean)
    assert not n.numpy().any()


def test_normal_decoder_matches_jax():
    """Normal 1/4 (GF(2^16), t = 12): the smallest normal code's T."""
    rng = np.random.default_rng(12)
    bits = _codewords(NORMAL_1_4, [3, 12, 13, 0], rng, parity_only=(1,))
    bits_t = np.ascontiguousarray(bits.T)
    jdec = jbch.BCHDecoder(*NORMAL_1_4)
    dec = bch.BCHDecoder(*NORMAL_1_4, device="cpu")
    want_t, want_n = jdec.decode_lane_major(jnp.asarray(bits_t))
    got_t, got_n = dec.decode_lane_major(torch.from_numpy(bits_t))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_n.numpy(), [3, 12, -1, 0])


def _bbframes(modcod, frame_size, n_frames, rng):
    tx = Transmitter(TxConfig(modcod=modcod, frame_size=frame_size))
    pkts = rng.integers(0, 256, (n_frames * tx.df_bytes // 188 + 2, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    return np.ascontiguousarray(
        tx.bbframes(pkts.reshape(-1))[:n_frames] ^ tx.bb_scramble)


def _crc_windows(frames, window=187):
    """ok[p] = crc8(bytes[max(0, p - window):p]) == bytes[p], from the
    definition: one table step per byte of every window."""
    T = crc8_table().astype(np.int64)
    B, n = frames.shape
    padded = np.concatenate([np.zeros((B, window), np.int64),
                             frames.astype(np.int64)], axis=1)
    rem = np.zeros((B, n), np.int64)
    for k in range(window):
        rem = T[rem ^ padded[:, k: k + n]]
    return rem == frames


@pytest.mark.parametrize("modcod,frame_size,n", [
    ("qpsk1/2", "short", 879), ("qpsk1/2", "normal", 4026),
    ("8psk3/5", "normal", 4836), (None, None, 883)])
def test_packet_validity_matches_jax(modcod, frame_size, n):
    rng = np.random.default_rng(n)
    if modcod is None:
        frames = rng.integers(0, 256, (5, n), dtype=np.uint8)
    else:
        frames = _bbframes(modcod, frame_size, 3, rng)
        frames = np.concatenate(
            [frames, rng.integers(0, 256, (2, n), dtype=np.uint8)])
    assert frames.shape[1] == n and n % 8
    frames[-1, :] = 0
    got_ok, got_hdr = crc8_dev.packet_validity(torch.from_numpy(frames))
    want_ok, want_hdr = jcrc.packet_validity(jnp.asarray(frames))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_hdr.numpy(), np.asarray(want_hdr))
    ok = _crc_windows(frames)
    np.testing.assert_array_equal(
        got_ok.numpy(), np.packbits(ok, axis=1, bitorder="little"))
    if modcod is not None:
        assert got_hdr.numpy()[:3].all()


def _crc8_kernel_mirror(frames, window):
    """csrc/crc8.cu's arithmetic in numpy, from the wrapper's tables
    (``crc8_cuda.tables``) and constants: each thread's run of RUN bytes
    (zero past the row), its local CRCs at bytes 3, 7, 11, 15 by slicing by
    4 (U_k); the Kogge-Stone scan of the run states within each warp of 32
    runs with A_0..A_4 (a lane below the step takes nothing, as a shuffle
    gives it), the warps' totals scanned with A_5..A_8, and the state
    before each run, the warp-local one plus C[the warps before, lane];
    the prefix S at bytes 4g + 3 from P_g and the rest by T steps, then
    the window test S[p-1] ^ Z[S[p-W-1]] == b[p] over PAD zero prefix
    CRCs, and hdr_ok = S[8] == b[9]."""
    rows = crc8_cuda.N_TABLES * 256
    flat = crc8_cuda.tables(window).astype(np.int64)
    tab = flat[:rows].reshape(crc8_cuda.N_TABLES, 256)
    Cl = flat[rows:].reshape(256, 32)
    U = tab[crc8_cuda.ROW_U:crc8_cuda.ROW_U + 4]
    P = tab[crc8_cuda.ROW_P:crc8_cuda.ROW_P + 4]
    Z, A = tab[crc8_cuda.ROW_Z], tab[crc8_cuda.ROW_A:]
    run = crc8_cuda.RUN
    B, n = frames.shape
    nt = crc8_cuda.threads(n)
    assert nt % 32 == 0 and nt <= crc8_cuda.MAX_THREADS
    runs = -(-n // run)
    b = np.zeros((B, nt * run), np.int64)
    b[:, :n] = frames
    b = b.reshape(B, nt, run)
    s = np.zeros((B, nt), np.int64)
    L = []
    for g in range(4):
        s = (U[3][s ^ b[..., 4 * g]] ^ U[2][b[..., 4 * g + 1]]
             ^ U[1][b[..., 4 * g + 2]] ^ U[0][b[..., 4 * g + 3]])
        L.append(s)
    lane = np.arange(nt) % 32
    e = s
    for k in range(5):
        d = 1 << k
        if d >= runs:
            break
        back = np.zeros_like(e)
        back[:, d:] = e[:, :-d]
        e = np.where(lane >= d, e ^ A[k][back], e)
    x = np.zeros_like(e)
    x[:, 1:] = e[:, :-1]
    x[:, lane == 0] = 0
    warps = nt // 32
    if warps > 1:
        w = e[:, 31::32]
        for k in range(4):
            d = 1 << k
            if d >= warps:
                break
            back = np.zeros_like(w)
            back[:, d:] = w[:, :-d]
            w = np.where(np.arange(warps) >= d, w ^ A[5 + k][back], w)
        before = np.repeat(w, 32, axis=1)[:, :-32]
        x[:, 32:] ^= Cl[before, lane[32:]]
    S = np.zeros((B, nt, run), np.int64)
    for g in range(4):
        S[..., 4 * g + 3] = L[g] ^ P[g][x]
    for g in range(4):
        prev = S[..., 4 * g - 1] if g else x
        for m in range(3):
            prev = U[0][prev ^ b[..., 4 * g + m]]
            S[..., 4 * g + m] = prev
    pad = crc8_cuda.PAD
    flat = np.concatenate([np.zeros((B, pad), np.int64), S.reshape(B, -1)], 1)
    p = np.arange(nt * run)
    old = flat[:, pad + p - window - 1]
    prev = np.concatenate([x[..., None], S[..., :-1]], -1).reshape(B, -1)
    ok = ((prev ^ Z[old]) == b.reshape(B, -1)) & (p < n)
    hdr = (S[:, 0, 8] == b[:, 0, 9]).astype(np.int32)
    return np.packbits(ok[:, :n], axis=1, bitorder="little"), hdr


def _crc8_rows(n, window, rng):
    """Three rows of n bytes: random bytes; a zero prefix of 300 bytes
    before random ones; and packets of ``window`` random bytes, each
    followed by the CRC-8 of those bytes (so most windows are valid)."""
    frames = rng.integers(0, 256, (3, n), dtype=np.uint8)
    frames[1, :300] = 0
    T = crc8_table()
    for p in range(window, n, window + 1):
        rem = 0
        for v in frames[2, p - window:p]:
            rem = int(T[rem ^ int(v)])
        frames[2, p] = rem
    return frames


@pytest.mark.parametrize("window", [1, 187, 255])
@pytest.mark.parametrize("n", [10, 879, 4026, 7274, 8192])
def test_crc8_kernel_arithmetic_mirrored(n, window):
    """csrc/crc8.cu's scan of run CRCs (``_crc8_kernel_mirror``) against
    the plain version and the JAX packet_validity, bit for bit."""
    frames = _crc8_rows(n, window, np.random.default_rng(n + window))
    got = _crc8_kernel_mirror(frames, window)
    want = crc8_dev.packet_validity_plain(torch.from_numpy(frames), window)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    jwant = jcrc.packet_validity(jnp.asarray(frames), window)
    np.testing.assert_array_equal(got[0], np.asarray(jwant[0]))
    np.testing.assert_array_equal(got[1], np.asarray(jwant[1]))
    if n > window:
        assert np.unpackbits(got[0][2], bitorder="little")[
            window:n:window + 1].all()


def test_crc8_tables_are_powers_of_the_byte_advance():
    """crc8_cuda.tables: every row the power of M its name says, checked
    by stepping the CRC table one zero byte at a time."""
    T = crc8_table()

    def steps(e):
        R = np.arange(256, dtype=np.uint8)
        for _ in range(e):
            R = T[R]
        return R

    flat = crc8_cuda.tables(187)
    tab = flat[:crc8_cuda.N_TABLES * 256].reshape(crc8_cuda.N_TABLES, 256)
    Cl = flat[crc8_cuda.N_TABLES * 256:].reshape(256, 32)
    for lane in range(32):
        np.testing.assert_array_equal(Cl[:, lane], steps(crc8_cuda.RUN * lane))
    for k in range(4):
        np.testing.assert_array_equal(tab[crc8_cuda.ROW_U + k], steps(k)[T])
        np.testing.assert_array_equal(tab[crc8_cuda.ROW_P + k],
                                      steps(4 * k + 4))
    np.testing.assert_array_equal(tab[crc8_cuda.ROW_Z], steps(187))
    for k in range(crc8_cuda.LEVELS):
        np.testing.assert_array_equal(tab[crc8_cuda.ROW_A + k],
                                      steps(crc8_cuda.RUN << k))
    assert [crc8_cuda.threads(n) for n in (10, 879, 4026, 7274, 8192)] == \
        [32, 64, 256, 480, 512]


def _u32(x):
    return np.asarray(x, np.uint32)


def _wrap(x, ordn):
    """csrc/bch.cu's wrap: x mod ord for x < 2 ord, in uint32 arithmetic
    (below ord, x - ord wraps high and the min keeps x)."""
    x = _u32(x)
    return np.minimum(x, x - np.uint32(ordn))


def _fold(x, ordn):
    """csrc/bch.cu's fold: x mod (2^m - 1) as (x & ord) + (x >> m)."""
    x = _u32(x)
    return _wrap((x & np.uint32(ordn)) + (x >> np.uint32(ordn.bit_length())),
                 ordn)


@pytest.fixture(scope="module")
def locator_codes():
    """Per code of LOCATOR_CODES: the port's CPU decoder, a JAX decoder
    holding only its syndrome matrix (the full one builds T), and B =
    2t + 4 codewords carrying 0..2t+3 errors, every third frame's in the
    parity bits only."""
    out = {}
    for name, code in LOCATOR_CODES.items():
        framesize, t, nbch, kbch = code
        dec = bch.BCHDecoder(*code, device="cpu")
        jdec = object.__new__(jbch.BCHDecoder)
        jdec.t, jdec.m = t, dec.m
        jdec._A = jbch_spec.syndrome_bit_matrix(framesize, t, nbch).astype(
            np.int8)
        rng = np.random.default_rng(nbch)
        n_errs = np.arange(2 * t + 4)
        bits = _codewords(code, n_errs, rng,
                          parity_only=tuple(range(1, 2 * t + 4, 3)))
        out[name] = (dec, jdec, bits, n_errs)
    return out


def _staged_syndromes(buf, sb, se, B, dec, n_sm=132):
    """The locator kernel's syndrome stage on the bits buffer ``buf`` with
    strides (sb, se) in elements (frame f, position e at f sb + e se):
    ``locator_plan``'s grid, each block staging STAGE_QUADS quads at a time
    in two halves (frames past B read as 0), warp w XOR-ing the table rows
    of its share of each half, in pairs of positions, into its lane's
    words, the block's warps XOR-ed together and
    the blocks' sums XOR-ed into the group's accumulators; then the odd
    syndromes from the accumulators' halves and the even ones by squaring
    (log S_2j = 2 log S_j mod ord). -> (B, 2t) int64."""
    t, nbch, ordn = dec.t, dec.nbch, dec.ord
    odd = bch.odd_power_table(dec._exp16, t, nbch, ordn).numpy().view(
        np.uint32)
    kw = odd.shape[1]
    assert kw == bch.odd_words(t)
    groups, chunks = bch_cuda.locator_plan(B, nbch, n_sm)
    quads, warps = nbch // 4, bch_cuda.LOCATOR_WARPS
    flat = buf.reshape(-1)
    acc = np.zeros((groups * 32, kw), np.uint32)
    for g in range(groups):
        f = 32 * g + np.arange(32)
        for c in range(chunks):
            q0, q1 = c * quads // chunks, (c + 1) * quads // chunks
            assert q1 - q0 >= warps
            s_w = np.zeros((warps, 32, kw), np.uint32)
            for qs in range(q0, q1, bch_cuda.STAGE_QUADS):
                n_p = 4 * min(bch_cuda.STAGE_QUADS, q1 - qs)
                e = 4 * qs + np.arange(n_p)
                idx = np.minimum(f[None, :] * sb + e[:, None] * se,
                                 flat.size - 1)
                staged = np.where(f[None, :] < B, flat[idx], 0)   # (n_p, 32)
                rows = odd[e]
                half = 4 * ((n_p // 4 + 1) // 2)    # two halves in flight
                for p0, p1 in ((0, half), (half, n_p)):
                    pairs = (p1 - p0) // 2
                    for w in range(warps):  # pairs of positions a warp
                        pa = p0 + 2 * (pairs * w // warps)
                        pb = p0 + 2 * (pairs * (w + 1) // warps)
                        sel = (staged[pa:pb] & 1).astype(np.uint32)
                        terms = rows[pa:pb, None, :] * sel[..., None]
                        s_w[w] ^= np.bitwise_xor.reduce(terms, axis=0)
            acc[32 * g: 32 * g + 32] ^= np.bitwise_xor.reduce(s_w, axis=0)
    acc = acc[:B]
    exp = dec._exp.numpy()
    log = dec._log.numpy()
    S = np.zeros((B, 2 * t), np.int64)
    for j in range(1, 2 * t + 1):
        if j % 2:
            k = (j - 1) // 2
            S[:, j - 1] = (acc[:, k // 2] >> (16 * (k % 2))) & 0xFFFF
        else:
            h = S[:, j // 2 - 1]
            S[:, j - 1] = np.where(h == 0, 0,
                                   exp[(2 * log[h]) % ordn])
    return S


@pytest.mark.parametrize("layout", ["lane-major", "rows"])
@pytest.mark.parametrize("code", list(LOCATOR_CODES))
def test_locator_syndrome_stage_mirrored(locator_codes, code, layout):
    """The staged, chunked odd syndromes and the squared even ones equal
    the plain product (``_syndromes``) and the JAX decoder's, on 0..2t+3
    errors, with the bits in either layout (the lane-major decode's (nbch,
    B) buffer, or rows of frames)."""
    dec, jdec, bits, n_errs = locator_codes[code]
    B = bits.shape[0]
    if layout == "lane-major":
        buf, sb, se = np.ascontiguousarray(bits.T), 1, B
    else:
        buf, sb, se = bits, dec.nbch, 1
    got = _staged_syndromes(buf, sb, se, B, dec)
    want = dec._syndromes(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jdec._syndromes(jnp.asarray(bits))))
    assert not got[n_errs == 0].any() and got[n_errs > 0].any(axis=1).all()


def test_locator_plan_covers_every_position_once():
    """Every quad of positions falls in one block of each group, every warp
    gets at least one quad, and the grid is one block per multiprocessor
    (or fewer, where the code has too few quads)."""
    for B, nbch in ((1, 7200), (2, 7200), (8, 32400), (37, 43200),
                    (128, 32400), (128, 57600), (1024, 16200), (4, 3240)):
        groups, chunks = bch_cuda.locator_plan(B, nbch, 132)
        assert groups == -(-B // 32) and groups * chunks <= max(132, groups)
        quads = nbch // 4
        edges = [c * quads // chunks for c in range(chunks + 1)]
        assert edges[0] == 0 and edges[-1] == quads
        assert min(np.diff(edges)) >= bch_cuda.LOCATOR_WARPS


def _bm_log_domain(S, dec):
    """csrc/bch.cu's Berlekamp-Massey rounds in the log domain, 8 lanes a
    frame (lane r holds the coefficients i = r + 8q of C and x^m B, cut at
    2t + 1): the syndromes' logs (a zero's log is 2^28; any log >= 2^27
    counts as zero), each lane's terms log C[i] + log S[n-i], i <= n, summed
    by the Zech table as a tree, the 8 lanes' sums joined by butterfly
    (lane r with lane r ^ 1, 2, 4), the update of C with log(d/b) x^m B,
    and x^m B shifted one coefficient up (x C after a length change), all in
    uint32 arithmetic. -> (sigma (B, t+1), L (B,)) int64."""
    t, ordn = dec.t, dec.ord
    W, Z = 2 * t + 1, np.uint32(1 << 28)
    Q = (W + 7) // 8
    zech = bch.zech_table(dec._exp16, dec._log16, ordn).numpy().view(
        np.uint16).astype(np.uint32)
    log16 = dec._log16.numpy().view(np.uint16).astype(np.uint32)
    exp = dec._exp.numpy()
    B = S.shape[0]

    def add(la, lb):
        lo = np.minimum(la, lb)
        k = np.maximum(la, lb) - lo
        r = _wrap(lo + zech[np.minimum(k, ordn)], ordn)
        return np.where(k == 0, Z, r).astype(np.uint32)

    ls = log16[S]
    ls = np.where(ls == 0xFFFF, Z, ls).astype(np.uint32)       # (B, 2t)
    i_all = np.arange(8 * Q)
    lc = np.full((B, 8 * Q), Z, np.uint32)
    lb = np.full((B, 8 * Q), Z, np.uint32)
    lc[:, 0] = 0
    lb[:, 1] = 0
    logb = np.zeros(B, np.uint32)
    L = np.zeros(B, np.int64)
    for n in range(2 * t):
        term = np.full((B, 8 * Q), Z, np.uint32)
        live = i_all <= n
        term[:, live] = _wrap(lc[:, live] + ls[:, n - i_all[live]], ordn)
        tm = [term[:, 8 * q: 8 * q + 8] for q in range(Q)]
        part = add(add(tm[0], tm[1]),
                   add(tm[2], tm[3]) if Q == 4 else tm[2])
        for o in (1, 2, 4):
            part = add(part, part[:, np.arange(8) ^ o])
        assert (part == part[:, :1]).all()
        ld = part[:, 0]
        update = ld < ordn
        grow = update & (2 * L <= n)
        lq = _wrap(ld + np.uint32(ordn) - logb, ordn)
        lcn = add(lc, _wrap(lq[:, None] + lb, ordn))
        src = np.where(grow[:, None], lc, lb)
        lb = np.full_like(lb, Z)
        lb[:, 1:W] = src[:, : W - 1]
        L = np.where(grow, n + 1 - L, L)
        logb = np.where(grow, ld, logb)
        lc = np.where(update[:, None], lcn, lc)
    lc = lc[:, : t + 1]
    sigma = np.where(lc >= ordn, 0, exp[np.minimum(lc, ordn)])
    return sigma.astype(np.int64), L


@pytest.mark.parametrize("framesize,t", [
    ("short", 12), ("normal", 12), ("normal", 10), ("normal", 8)])
def test_locator_berlekamp_massey_mirrored(framesize, t):
    """The locator kernel's log-domain rounds give berlekamp_massey_plain's
    and the JAX loop's sigma and L on the syndromes of 0..2t+3 errors, on
    random syndromes (no code's, so most are uncorrectable) and on zeros."""
    rng = np.random.default_rng(30 + t)
    jdec, _ = _gf_pair(framesize, t)
    nbch = 7200 if framesize == "short" else 57600
    code = (framesize, t, nbch, nbch - 16 * t)
    dec = bch.BCHDecoder(*code, device="cpu")
    real = _error_syndromes(bch_spec.field_for(framesize), t,
                            np.arange(2 * t + 4), nbch, rng)
    rand = rng.integers(0, dec.ord + 1, (12, 2 * t))
    S = np.concatenate([real, rand, np.zeros((1, 2 * t), np.int64)])
    sig, L = _bm_log_domain(S, dec)
    sig_p, L_p = bch.berlekamp_massey_plain(torch.from_numpy(S), dec._exp,
                                            dec._log, t, dec.ord)
    np.testing.assert_array_equal(sig, sig_p.numpy())
    np.testing.assert_array_equal(L, L_p.numpy())
    jsig, jL = jdec._berlekamp_massey(jnp.asarray(S, jnp.int32))
    np.testing.assert_array_equal(sig, np.asarray(jsig))
    np.testing.assert_array_equal(L, np.asarray(jL))


def test_kernel_tables_match_their_definitions(short_pair):
    """The odd-power rows are the syndrome matrix's odd columns, packed two
    to a word; Z(k) = log(1 + alpha^k), Z(0) marked and Z(ord) = 0; the
    plain versions' tables come back from the 16-bit ones."""
    _, dec = short_pair
    t, nbch, ordn, m = dec.t, dec.nbch, dec.ord, dec.m
    A = bch_spec.syndrome_bit_matrix("short", t, nbch).reshape(nbch, 2 * t, m)
    vals = (A.astype(np.int64) << np.arange(m)).sum(-1)       # (nbch, 2t)
    odd = bch.odd_power_table(dec._exp16, t, nbch, ordn).numpy().view(
        np.uint32)
    for k in range(t):
        np.testing.assert_array_equal(
            (odd[:, k // 2] >> (16 * (k % 2))) & 0xFFFF, vals[:, 2 * k])
    z = bch.zech_table(dec._exp16, dec._log16, ordn).numpy().view(np.uint16)
    exp, log = dec._exp.numpy(), dec._log.numpy()
    k = np.arange(1, ordn)
    np.testing.assert_array_equal(z[k], log[1 ^ exp[k]])
    assert z[0] == 0xFFFF and z[ordn] == 0 and z.size == ordn + 1
    e, lg = bch.field_tables(dec._exp16, dec._log16, ordn)
    assert torch.equal(e, dec._exp) and torch.equal(lg, dec._log)
    np.testing.assert_array_equal(
        bch.syndrome_matrix(dec._exp16, t, nbch, ordn).numpy(),
        A.reshape(nbch, -1).astype(np.float32))


def test_chien_kernel_arithmetic_mirrored(short_pair):
    """csrc/bch.cu's Chien evaluation: sigma(alpha^(-p_e)) as the XOR of
    exp[(log sigma_i - i p_e) mod ord] over the list of nonzero
    coefficients, thread k at positions k and k + 512, then k + 1024 and
    k + 1536, ..., its exponents set up with the Mersenne fold and stepped
    by 1024 i mod ord; its roots are the plain version's error mask, and
    the kernel's n_corr rule (0 clean, -1 when L > t or the roots are not
    L, else the roots) its n_corr."""
    _, dec = short_pair
    rng = np.random.default_rng(5)
    n_errs = [0, 1, 6, 12, 13, 19]
    bits = torch.from_numpy(_codewords(SHORT, n_errs, rng))
    S = dec._syndromes(bits)
    sig, L = bch.berlekamp_massey_plain(S, dec._exp, dec._log, dec.t,
                                        dec.ord)
    err, _ = bch.chien_plain(sig, dec.chien_matrix(), dec.t)
    _, want_n = bch.correct_plain(bits, S, sig.contiguous(), L,
                                  dec.chien_matrix(), dec.t)
    ordn = dec.ord
    exp16 = dec._exp.numpy()[:ordn].astype(np.uint16)
    log = dec._log.numpy()
    K = bch_cuda.CHIEN_THREADS
    k = np.arange(K)                    # the threads, side by side
    p0 = _u32(np.maximum(dec.nbch - 1 - k, 0))
    for b in range(len(n_errs)):
        s = sig[b].numpy()
        coef = [i for i in range(dec.t + 1) if s[i]]  # the compact list
        v = np.zeros(-(-dec.nbch // (2 * K)) * 2 * K, np.int64)
        xa, xb, st = {}, {}, {}
        for i in coef:
            xa[i] = _wrap(np.uint32(log[s[i]] + ordn) - _fold(i * p0, ordn),
                          ordn)
            xb[i] = _wrap(xa[i] + _fold(i * K, ordn), ordn)
            st[i] = _fold(i * 2 * K, ordn)
        for e0 in range(0, dec.nbch, 2 * K):
            for i in coef:
                v[e0 + k] ^= exp16[xa[i]]
                v[e0 + K + k] ^= exp16[xb[i]]
                xa[i] = _wrap(xa[i] + st[i], ordn)
                xb[i] = _wrap(xb[i] + st[i], ordn)
        v = v[: dec.nbch]
        np.testing.assert_array_equal(v == 0, err[b].numpy())
        roots = int((v == 0).sum())
        clean = not S[b].any()
        n = 0 if clean else (-1 if int(L[b]) > dec.t or roots != int(L[b])
                             else roots)
        assert n == int(want_n[b])


def test_wrappers_on_cpu_tensors_take_the_plain_version(short_pair,
                                                        monkeypatch):
    """No launch, no build: the kernel library is never asked for."""
    _, dec = short_pair

    def no_build():
        raise AssertionError("a CPU tensor asked for the kernel library")

    monkeypatch.setattr(_build, "lib", no_build)
    rng = np.random.default_rng(6)
    bits = torch.from_numpy(_codewords(SHORT, [0, 4, 15], rng))
    before = (dict(bch_cuda.LAUNCHES), crc8_cuda.LAUNCHES)
    loc = (None, dec._exp16, dec._log16, None, None, dec.t, dec.nbch,
           dec.ord)
    chien = (dec._exp16, dec._log, dec.t, dec.nbch, dec.ord)
    S, sig, L = bch_cuda.locator(bits, *loc)
    for g, w in zip((S, sig, L), bch.locator_plain(
            bits, dec.syndrome_matrix(), dec._exp, dec._log, dec.t,
            dec.ord)):
        assert torch.equal(g, w)
    assert torch.equal(S, dec._syndromes(bits)) and sig.is_contiguous()
    for g, w in zip((S, sig, L), dec.locator(bits)):
        assert torch.equal(g, w)
    got = bch_cuda.chien_correct(bits, S, sig, L, *chien)
    want = bch.correct_plain(bits, S, sig, L, dec.chien_matrix(), dec.t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].tolist() == [0, 4, -1]
    frames = torch.from_numpy(rng.integers(0, 256, (2, 100), np.uint8))
    got = crc8_cuda.crc8_validity(frames)
    want = crc8_dev.packet_validity_plain(frames)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (dict(bch_cuda.LAUNCHES), crc8_cuda.LAUNCHES) == before
    assert not any(bch_cuda.LAUNCHES.values()) and crc8_cuda.LAUNCHES == 0
    with pytest.raises(ValueError):
        bch_cuda.locator(bits.to(torch.int32), *loc)
    with pytest.raises(ValueError):
        bch_cuda.locator(bits, None, dec._exp16[:-8], *loc[2:])
    with pytest.raises(ValueError):
        bch_cuda.chien_correct(bits[:, :-1], S, sig, L, *chien)
    with pytest.raises(ValueError):
        crc8_cuda.crc8_validity(frames.to(torch.int16))


def test_importing_the_wrappers_builds_nothing():
    code = (
        "from dvbs2rx_tpu_torch import _build\n"
        "from dvbs2rx_tpu_torch.ops import bch_cuda, crc8_cuda\n"
        "from dvbs2rx_tpu_torch.ops import bch, crc8_dev\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "assert _build.build_log == ''\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
