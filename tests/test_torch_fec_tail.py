"""The FEC tail's plain versions against the JAX package, bit for bit, and
the arithmetic of their CUDA kernels mirrored in numpy.

On the CPU the port's ``BCHDecoder`` runs its plain Berlekamp-Massey loop
and Chien product (``ops/bch.py``; the wrappers of ``ops/bch_cuda.py`` take
them for CPU tensors too), and ``packet_validity`` its plain prefix scan
(``ops/crc8_cuda.py``). These
tests hold them to ``dvbs2rx_tpu/ops/bch.py`` and ``crc8_dev.py``:

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
(the sliding window CRC of ``csrc/crc8.cu``, the log-domain Chien
evaluation of ``csrc/bch.cu``) against the plain versions; the wrappers on
CPU tensors take the plain version, launch nothing, and importing them
builds nothing. The on-card tier is ``tests/test_torch_cuda.py``.
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


def test_crc8_kernel_arithmetic_mirrored():
    """csrc/crc8.cu's recurrence: runs of 32 positions, the first window's
    CRC by table steps, then rem' = T[rem ^ b[p]] ^ Z[b[p - W]] with the
    wrapper's Z table, against the plain version."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 883), dtype=np.uint8)
    frames[0, :200] = 0
    W, run = 187, crc8_cuda.RUN
    tab = crc8_cuda.tables(W).astype(np.int64)
    T, Z = tab[:256], tab[256:]
    B, n = frames.shape
    buf = np.concatenate([np.zeros((B, W), np.int64), frames,
                          np.zeros((B, run), np.int64)], axis=1)
    ok = np.zeros((B, n), bool)
    for p0 in range(0, n, run):
        rem = np.zeros(B, np.int64)
        for k in range(W):
            rem = T[rem ^ buf[:, p0 + k]]
        for p in range(p0, min(p0 + run, n)):
            ok[:, p] = rem == buf[:, p + W]
            rem = T[rem ^ buf[:, p + W]] ^ Z[buf[:, p]]
    want, _ = crc8_dev.packet_validity_plain(torch.from_numpy(frames))
    np.testing.assert_array_equal(
        np.packbits(ok, axis=1, bitorder="little"), want.numpy())


def test_chien_kernel_arithmetic_mirrored(short_pair):
    """csrc/bch.cu's Chien evaluation: sigma(alpha^(-p_e)) as the XOR of
    exp[(log sigma_i - i p_e) mod ord] over the nonzero coefficients, thread
    k at positions k, k + 1024, ..., each exponent stepped by 1024 i from
    one to the next; its roots are the plain version's error mask, and the
    kernel's n_corr rule (0 clean, -1 when L > t or the roots are not L,
    else the roots) its n_corr."""
    _, dec = short_pair
    rng = np.random.default_rng(5)
    n_errs = [0, 1, 6, 12, 13, 19]
    bits = torch.from_numpy(_codewords(SHORT, n_errs, rng))
    S = dec._syndromes(bits)
    sig, L = bch.berlekamp_massey_plain(S, dec._exp, dec._log, dec.t,
                                        dec.ord)
    err, _ = bch.chien_plain(sig, dec.chien_matrix(), dec.t)
    _, want_n = bch.correct_plain(bits, S, sig, L, dec.chien_matrix(), dec.t)
    exp16 = dec._exp.numpy()[: dec.ord].astype(np.uint16)
    log = dec._log.numpy()
    K = bch_cuda.CHIEN_THREADS
    assert dec.t * K < dec.ord          # one conditional subtract wraps
    k = np.arange(K)                    # the threads, side by side
    for b in range(len(n_errs)):
        s = sig[b].numpy()
        v = np.zeros(-(-dec.nbch // K) * K, np.int64)
        x = {i: (int(log[s[i]]) - i * (dec.nbch - 1 - k)) % dec.ord
             for i in range(dec.t + 1) if s[i]}
        for e0 in range(0, dec.nbch, K):
            for i in x:
                v[e0 + k] ^= exp16[x[i]]
                x[i] = x[i] + i * K
                x[i] = np.where(x[i] >= dec.ord, x[i] - dec.ord, x[i])
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
    S = dec._syndromes(bits)
    before = (dict(bch_cuda.LAUNCHES), crc8_cuda.LAUNCHES)
    bm = (dec._exp, dec._log, dec.t, dec.ord)
    chien = (dec._exp16, dec._log, dec.t, dec.nbch, dec.ord)
    sig, L = bch_cuda.berlekamp_massey(S, *bm)
    sig_p, L_p = bch.berlekamp_massey_plain(S, *bm)
    assert torch.equal(sig, sig_p) and torch.equal(L, L_p)
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
        bch_cuda.berlekamp_massey(S.to(torch.int32), *bm)
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
