"""The port's own ``spec``, ``io.native`` and ``tx`` copies against their
originals in the JAX package.

Every comparison is exact (integer tables, numpy float arithmetic in the
same order). Inputs come from numpy seeds; nothing here compiles JAX: the
originals compared are the JAX package's numpy-only modules.
"""

import dataclasses

import numpy as np
import pytest
import torch

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

from dvbs2rx_tpu_torch.io import native
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
