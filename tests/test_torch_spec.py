"""The port's own ``spec``, ``io`` (``native``, ``iq``), ``utils.params``
and ``tx`` copies against their originals in the JAX package.

Every comparison is exact (integer tables, numpy float arithmetic in the
same order). Inputs come from numpy seeds; nothing here compiles JAX: the
originals compared are the JAX package's numpy-only modules.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.io import iq as jiq
from dvbs2rx_tpu.io import native as jnative
from dvbs2rx_tpu.spec import bb_frame as jbb
from dvbs2rx_tpu.spec import bch_spec as jbch
from dvbs2rx_tpu.spec import constellations as jconst
from dvbs2rx_tpu.spec import fec_params as jfec
from dvbs2rx_tpu.spec import interleaver as jinter
from dvbs2rx_tpu.spec import ldpc_tables as jldpc
from dvbs2rx_tpu.spec import pi2_bpsk as jpi2
from dvbs2rx_tpu.spec import pl_defs as jpl
from dvbs2rx_tpu.spec import pls as jpls
from dvbs2rx_tpu.spec import reed_muller as jrm
from dvbs2rx_tpu.spec import rrc as jrrc
from dvbs2rx_tpu.spec import scramblers as jscr
from dvbs2rx_tpu.tx import transmitter as jtx
from dvbs2rx_tpu.tx import vcm as jvcm
from dvbs2rx_tpu.utils import params as jparams

from dvbs2rx_tpu_torch.io import iq, native
from dvbs2rx_tpu_torch.ops.crc8_dev import packet_validity
from dvbs2rx_tpu_torch.spec import (
    bb_frame,
    bch_spec,
    constellations,
    fec_params,
    interleaver,
    ldpc_tables,
    pi2_bpsk,
    pl_defs,
    pls,
    reed_muller,
    rrc,
    scramblers,
)
from dvbs2rx_tpu_torch.tx import transmitter, vcm
from dvbs2rx_tpu_torch.utils import params

TABLES = jldpc.available_tables()


def test_available_tables_match():
    assert ldpc_tables.available_tables() == TABLES
    assert len(TABLES) >= 40


@pytest.mark.parametrize("name", TABLES)
def test_ldpc_code_fields_match(name):
    a, b = jldpc.get_code(name), ldpc_tables.get_code(name)
    for f in ("name", "M", "N", "K", "links_total", "links_max_cn", "q",
              "n_blocks"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.block_addr) == len(b.block_addr)
    for x, y in zip(a.block_addr, b.block_addr):
        np.testing.assert_array_equal(x, y)
    for k, v in a.layers.items():
        np.testing.assert_array_equal(b.layers[k], v, err_msg=k)
    for x, y in zip(a.encode_edges, b.encode_edges):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("framesize,t,nbch", [
    ("normal", 12, 32400), ("normal", 10, 43200), ("normal", 8, 57600),
    ("short", 12, 7200),
])
def test_bch_generators_and_tables_match(framesize, t, nbch):
    assert bch_spec.generator_poly(framesize, t) == \
        jbch.generator_poly(framesize, t)
    fa, fb = jbch.field_for(framesize), bch_spec.field_for(framesize)
    np.testing.assert_array_equal(fb.exp, fa.exp)
    np.testing.assert_array_equal(fb.log, fa.log)
    np.testing.assert_array_equal(
        bch_spec.syndrome_bit_matrix(framesize, t, nbch),
        jbch.syndrome_bit_matrix(framesize, t, nbch))
    kbch = nbch - (jbch.generator_poly(framesize, t).bit_length() - 1)
    msg = np.random.default_rng(t).integers(0, 256, kbch // 8, np.uint8)
    np.testing.assert_array_equal(
        bch_spec.bch_encode_bytes(msg, framesize, t),
        jbch.bch_encode_bytes(msg, framesize, t))


@pytest.mark.parametrize("gold", [0, 1, 77, 262141])
def test_pl_scrambling_matches(gold):
    np.testing.assert_array_equal(scramblers.pl_scrambling_rn(gold),
                                  jscr.pl_scrambling_rn(gold))
    np.testing.assert_array_equal(scramblers.pl_descrambling_sequence(gold),
                                  jscr.pl_descrambling_sequence(gold))


def test_bb_scrambling_and_crc8_match():
    for nbytes in (879, 2001, 8100):
        np.testing.assert_array_equal(scramblers.bb_derandomizer_bytes(nbytes),
                                      jscr.bb_derandomizer_bytes(nbytes))
    np.testing.assert_array_equal(scramblers.crc8_table(), jscr.crc8_table())
    assert scramblers.CRC8_POLY == jscr.CRC8_POLY
    rng = np.random.default_rng(3)
    for n in (1, 9, 187, 188):
        data = rng.integers(0, 256, n, np.uint8)
        assert scramblers.crc8(data) == jscr.crc8(data)
        assert scramblers.crc8_check(data) == jscr.crc8_check(data)


def test_pls_make_and_parse_match_over_all_codes():
    for v in range(128):
        assert dataclasses.asdict(pls.parse_pls(v)) == \
            dataclasses.asdict(jpls.parse_pls(v))
    for modcod in range(32):
        for short in (False, True):
            for pilots in (False, True):
                assert pls.make_pls(modcod, short, pilots) == \
                    jpls.make_pls(modcod, short, pilots)


def test_fec_params_rows_match():
    assert fec_params.FEC_TABLE == jfec.FEC_TABLE
    assert fec_params.LDPC_TABLE_MAP == jfec.LDPC_TABLE_MAP
    assert fec_params.DVBS2_MODCODS == jfec.DVBS2_MODCODS
    assert fec_params.MODCOD_NUMBERS == jfec.MODCOD_NUMBERS
    for rate, sizes in jfec._RATE_ENUMS.items():
        for framesize in sizes:
            assert dataclasses.asdict(fec_params.get_fec_info(framesize, rate)) \
                == dataclasses.asdict(jfec.get_fec_info(framesize, rate))
    with pytest.raises(ValueError):
        fec_params.get_fec_info("short", "9/10")


def test_modulation_tables_match():
    for name in ("SOF_BITS", "PLSC_SCRAMBLER_BITS"):
        np.testing.assert_array_equal(getattr(pl_defs, name),
                                      getattr(jpl, name))
    for name in ("MAX_PLFRAME_PAYLOAD", "PILOT_BLK_PERIOD", "SQRT2_2"):
        assert getattr(pl_defs, name) == getattr(jpl, name)
    np.testing.assert_array_equal(reed_muller.codeword_bits(),
                                  jrm.codeword_bits())
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 90, np.uint8)
    np.testing.assert_array_equal(pi2_bpsk.map_bpsk(bits), jpi2.map_bpsk(bits))
    cases = [("QPSK", "1/2"), ("8PSK", "3/5"), ("8PSK", "2/3"),
             ("16APSK", "3/4"), ("32APSK", "4/5")]
    for const, rate in cases:
        n_mod = constellations.BITS_PER_SYMBOL[const]
        np.testing.assert_array_equal(
            constellations.constellation_points(const, rate),
            jconst.constellation_points(const, rate))
        cw = rng.integers(0, 2, 360 * n_mod, np.uint8)
        assert interleaver.column_order(const, rate) == \
            jinter.column_order(const, rate)
        sym_bits = interleaver.interleave(cw, const, rate)
        np.testing.assert_array_equal(sym_bits,
                                      jinter.interleave(cw, const, rate))
        np.testing.assert_array_equal(
            constellations.map_bits(sym_bits, const, rate),
            jconst.map_bits(sym_bits, const, rate))
    for args in ((2, 0.2, 5, 128), (2, 0.35, 5, 32)):
        for x, y in zip(rrc.polyphase_rrc_bank(*args),
                        jrrc.polyphase_rrc_bank(*args)):
            np.testing.assert_array_equal(x, y)


def _packets(n, seed):
    pkts = np.random.default_rng(seed).integers(0, 256, (n, 188), np.uint8)
    pkts[:, 0] = 0x47
    return pkts.reshape(-1)


@pytest.mark.parametrize("modcod,pilots,n_pkts", [
    ("qpsk1/2", False, 12), ("8psk3/5", True, 16),
])
def test_transmitter_and_channel_give_the_same_bytes(modcod, pilots, n_pkts):
    kw = dict(modcod=modcod, frame_size="short", pilots=pilots, gold_code=5)
    ts = _packets(n_pkts, seed=n_pkts)
    ours = transmitter.Transmitter(transmitter.TxConfig(**kw)).ts_to_iq(ts)
    ref = jtx.Transmitter(jtx.TxConfig(**kw)).ts_to_iq(ts)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.size > 0
    assert ours.tobytes() == ref.tobytes()
    a = transmitter.awgn_channel(ours, 7.0, sps=2, freq_offset=1e-4,
                                 phase=0.3, seed=9)
    b = jtx.awgn_channel(ref, 7.0, sps=2, freq_offset=1e-4, phase=0.3,
                         seed=9)
    assert a.tobytes() == b.tobytes()


def test_scrambled_euclidean_images_match():
    ours, ref = reed_muller.scrambled_euclidean_images(), \
        jrm.scrambled_euclidean_images()
    assert ours.dtype == ref.dtype and ours.shape == (128, 64)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("schedule", [[0, 1], [1, -1, 0, -1, -1]])
def test_vcm_transmitter_gives_the_same_symbols(schedule):
    """Per-frame MODCOD over one mode-adaptation stream, dummy frames
    included, across two calls (the stream residue carries over)."""
    kws = [dict(modcod="qpsk1/2", frame_size="short", pilots=True),
           dict(modcod="8psk3/5", frame_size="short", pilots=False)]
    ours = vcm.VCMTransmitter([transmitter.TxConfig(**k) for k in kws],
                              gold_code=3)
    ref = jvcm.VCMTransmitter([jtx.TxConfig(**k) for k in kws], gold_code=3)
    assert ours.dummy_plframe().tobytes() == ref.dummy_plframe().tobytes()
    for seed in (1, 2):
        ts = _packets(23, seed=seed)
        a, b = ours.modulate_ts(ts, schedule), ref.modulate_ts(ts, schedule)
        assert a.dtype == b.dtype and a.size > 0
        assert a.tobytes() == b.tobytes()
    ts = _packets(17, seed=3)
    assert ours.ts_to_iq(ts, schedule).tobytes() == \
        ref.ts_to_iq(ts, schedule).tobytes()


def test_transmitter_refuses_fractional_sps():
    """Named from when the port had no resampler: fractional sps is now
    taken as the JAX ``TxConfig`` takes it (integers stay ``int``, a
    fractional sps must exceed 1), and shapes the same waveform."""
    assert transmitter.TxConfig(modcod="qpsk1/2", sps=4.0).sps == 4
    assert transmitter.TxConfig(modcod="qpsk1/2", sps=2.5).sps == 2.5
    with pytest.raises(ValueError):
        transmitter.TxConfig(modcod="qpsk1/2", sps=0.75)
    kw = dict(modcod="qpsk1/2", frame_size="short", sps=2.5)
    ts = _packets(40, seed=3)
    np.testing.assert_array_equal(
        transmitter.Transmitter(transmitter.TxConfig(**kw)).ts_to_iq(ts),
        jtx.Transmitter(jtx.TxConfig(**kw)).ts_to_iq(ts))


def _stitch_inputs():
    """Two channels x 3 steps x 2 descrambled BBFRAMEs, with a corrupt
    packet byte, a dropped header and a frame gap, plus the device CRC
    maps of the port (on the CPU)."""
    tx = jtx.Transmitter(jtx.TxConfig(modcod="qpsk1/2", frame_size="short"))
    frames = tx.bbframes(_packets(60, seed=1))[:6]
    frames = frames ^ jscr.bb_derandomizer_bytes(frames.shape[1])[None]
    C, T, F = 2, 3, 2
    blk = np.stack([frames, frames]).reshape(C, T, F, -1).copy()
    blk[0, 0, 1, 400] ^= 0x10                       # a TS packet CRC fails
    blk[1, 2, 0] = blk[1, 1, 0]                     # a gap: frame repeated
    ok, hdr = packet_validity(torch.from_numpy(blk.reshape(C * T * F, -1)))
    ok = ok.numpy().reshape(C, T, F, -1)
    hdr = hdr.numpy().reshape(C, T, F).astype(bool)
    hdr[1, 1, 1] = False                             # a dropped header
    return blk, ok, hdr


@pytest.mark.parametrize("use_native", [True, False])
def test_batch_ts_stitcher_gives_the_same_ts(monkeypatch, use_native):
    if not use_native:
        monkeypatch.setattr(native, "_ext", False)
        monkeypatch.setattr(jnative, "_ext", False)
    blk, ok, hdr = _stitch_inputs()
    C, T = blk.shape[:2]
    ours, ref = bb_frame.BatchTSStitcher(C), jbb.BatchTSStitcher(C)
    assert (ours._ext is None) == (ref._ext is None)
    if not use_native:
        assert ours._ext is None
    for t in range(T):
        a = ours.push_step(blk[:, t], ok[:, t], hdr[:, t])
        b = ref.push_step(blk[:, t], ok[:, t], hdr[:, t])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ours.counters, ref.counters)
    assert dataclasses.asdict(ours.stats) == dataclasses.asdict(ref.stats)
    st = ours.stats
    assert st.packet_cnt > 0 and st.error_cnt >= 1
    assert st.bbframe_drop_cnt == 1 and st.bbframe_gap_cnt >= 1


# ---- io.iq and the native IQ conversions ----

def _iq_samples(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    x[:4] = [[1.5, -1.5], [0.0, 0.0], [1.0 / 0.9, -1.0 / 0.9], [2.0, -2.0]]
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


@pytest.mark.parametrize("use_native", [True, False])
def test_iq_conversions_match(monkeypatch, use_native):
    if not use_native:
        monkeypatch.setattr(native, "_ext", False)
        monkeypatch.setattr(jnative, "_ext", False)
    x = _iq_samples(1001, seed=5)
    for scale in (0.9, 0.25):
        u8 = iq.fc32_to_u8(x, scale)
        assert u8.dtype == np.uint8 and u8.size == 2 * x.size
        np.testing.assert_array_equal(u8, jiq.fc32_to_u8(x, scale))
        np.testing.assert_array_equal(u8, native.fc32_to_u8(x, scale))
    raw = np.random.default_rng(6).integers(0, 256, 2002, dtype=np.uint8)
    back = iq.u8_to_fc32(raw)
    assert back.dtype == np.complex64 and back.size == 1001
    np.testing.assert_array_equal(back, jiq.u8_to_fc32(raw))
    # round trip within half a quantisation step per rail, inside full scale
    y = x[(np.abs(x.real) < 1) & (np.abs(x.imag) < 1)]
    rt = iq.u8_to_fc32(iq.fc32_to_u8(y, 0.9))
    for part in (np.real, np.imag):
        np.testing.assert_allclose(part(rt), part(y) * 0.9, rtol=0,
                                   atol=0.5 / 127.5 + 1e-6)


@pytest.mark.parametrize("fmt", ["fc32", "u8"])
def test_read_and_write_iq_match(tmp_path, fmt):
    x = _iq_samples(777, seed=7)
    a, b = tmp_path / "a", tmp_path / "b"
    iq.write_iq(str(a), x, fmt)
    jiq.write_iq(str(b), x, fmt)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(iq.read_iq(str(a), fmt),
                                  jiq.read_iq(str(b), fmt))
    fd = os.open(str(a), os.O_RDONLY)
    try:
        np.testing.assert_array_equal(iq.read_iq(fd, fmt),
                                      jiq.read_iq(str(b), fmt))
    finally:
        os.close(fd)
    with pytest.raises(ValueError, match="unknown IQ format"):
        iq.write_iq(str(a), x, "s16")
    with pytest.raises(ValueError, match="unknown IQ format"):
        iq.read_iq(str(a), "s16")


def _pipe_chunks(it_fn, payload, pieces):
    """Chunks ``it_fn(read_fd)`` yields while a thread writes ``payload``
    into a pipe in ``pieces`` (byte counts) and closes it."""
    r, w = os.pipe()

    def writer():
        pos = 0
        for n in pieces:
            os.write(w, payload[pos: pos + n])
            pos += n
        os.write(w, payload[pos:])
        os.close(w)

    t = threading.Thread(target=writer)
    t.start()
    try:
        chunks = list(it_fn(r))
    finally:
        t.join(timeout=30)
        os.close(r)
    assert not t.is_alive()
    return chunks


@pytest.mark.parametrize("fmt", ["fc32", "u8"])
def test_iter_iq_over_a_pipe_carries_partial_samples(fmt):
    """Odd-sized writes leave reads that end inside a sample (8 bytes for
    fc32, 2 for u8): the partial sample is carried into the next read, and
    the samples are those of the JAX ``iter_iq`` and of the whole stream."""
    x = _iq_samples(3001, seed=8)
    payload = (x.tobytes() if fmt == "fc32"
               else iq.fc32_to_u8(x).tobytes())
    pieces = [3, 5, 1, 7, 13, 2, 11, 1001, 9, 333]
    ours = _pipe_chunks(lambda fd: iq.iter_iq(fd, fmt, chunk_samples=37),
                        payload, pieces)
    ref = _pipe_chunks(lambda fd: jiq.iter_iq(fd, fmt, chunk_samples=37),
                       payload, pieces)
    assert len(ours) > len(pieces)
    whole = (x if fmt == "fc32"
             else iq.u8_to_fc32(np.frombuffer(payload, np.uint8)))
    np.testing.assert_array_equal(np.concatenate(ours), whole)
    np.testing.assert_array_equal(np.concatenate(ours), np.concatenate(ref))


def test_iter_iq_from_a_file_matches(tmp_path):
    x = _iq_samples(5000, seed=9)
    path = tmp_path / "x.fc32"
    x.tofile(path)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")          # a trailing partial sample
    a = list(iq.iter_iq(str(path), "fc32", chunk_samples=999))
    b = list(jiq.iter_iq(str(path), "fc32", chunk_samples=999))
    assert [c.size for c in a] == [c.size for c in b]
    np.testing.assert_array_equal(np.concatenate(a), x)


# ---- spec.pls.pls_filter and utils.params ----

def test_pls_filter_and_constellation_match():
    assert pls.pls_filter() == jpls.pls_filter()
    assert pls.pls_filter(0, 17, 49, 127) == jpls.pls_filter(0, 17, 49, 127)
    for v in range(128):
        assert pls.parse_pls(v).constellation == \
            jpls.parse_pls(v).constellation
    assert fec_params.ROLLOFFS == jfec.ROLLOFFS


def _outcome(fn, *a, **kw):
    """A call's result, or its exception's type and message."""
    try:
        return "ok", fn(*a, **kw)
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)


def _same_fec(a, b):
    if a[0] != "ok" or b[0] != "ok":
        return a == b
    const_a, rate_a, fec_a, pls_a = a[1]
    const_b, rate_b, fec_b, pls_b = b[1]
    return ((const_a, rate_a, pls_a) == (const_b, rate_b, pls_b)
            and dataclasses.asdict(fec_a) == dataclasses.asdict(fec_b))


@pytest.mark.parametrize("frame_size", ["normal", "short", "medium", "tiny"])
def test_params_validate_and_translate_match(frame_size):
    names = sorted(fec_params.MODCOD_NUMBERS) + ["qpsk9/9", "QPSK1/2"]
    for modcod in names:
        for standard in ("DVB-S2", "DVB-S2X", "DVB-T3"):
            for rolloff in (0.35, 0.2, 0.15, 0.3):
                for sps in (2, 4, 1, 2.5):
                    kw = dict(standard=standard, frame_size=frame_size,
                              modcod=modcod, rolloff=rolloff, sps=sps)
                    assert _outcome(params.validate, **kw) == \
                        _outcome(jparams.validate, **kw), kw
        for pilots in (False, True):
            assert _same_fec(
                _outcome(params.translate, modcod, frame_size, pilots),
                _outcome(jparams.translate, modcod, frame_size, pilots))


def test_params_pls_helpers_match():
    names = list(fec_params.MODCOD_NUMBERS) + list(range(32))
    for modcod in names:
        for short in (False, True):
            for pilots in (False, True):
                assert params.dvbs2_pls(modcod, short, pilots) == \
                    jparams.dvbs2_pls(modcod, short, pilots)
                assert params.pl_info(modcod, short, pilots) == \
                    jparams.pl_info(modcod, short, pilots)
    for vals in ((), (0,), (0, 63, 64, 127), tuple(range(0, 128, 3))):
        assert params.pls_filter(*vals) == jparams.pls_filter(*vals)
    for bad in (128, -1):
        assert _outcome(params.pls_filter, bad) == \
            _outcome(jparams.pls_filter, bad)
        with pytest.raises(ValueError, match="within"):
            params.pls_filter(bad)
    assert _outcome(params.dvbs2_pls, "qpsk9/9", False, False) == \
        _outcome(jparams.dvbs2_pls, "qpsk9/9", False, False)
