"""The port's FEC-side modules against the JAX package, bit for bit.

- BCH (``ops/bch``): clean, correctable (1..t errors) and uncorrectable
  frames in one lane-major batch, plus the row-major call; n_corr -1 for a
  failed frame. Exact.
- ``crc8_dev.packet_validity``: exact on Tx BBFRAMEs and on random bytes.
- ``demap``/``quantize_llrs``: exact int8 LLRs for QPSK, 8PSK and 16APSK
  (max-log) on the same symbols and N0; the demappers are elementwise
  float32 with the JAX operation order, so no rounding-boundary allowance
  is needed. The SNR estimators (sums) within rtol 1e-5.
- The FEC stage: exact kbytes, n_corr, iterations and convergence against
  ``Receiver._fec_stage_lane_major_impl``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvbs2rx_tpu.ops import bch as jbch
from dvbs2rx_tpu.ops import crc8_dev as jcrc
from dvbs2rx_tpu.ops import demap as jdemap
from dvbs2rx_tpu.rx.receiver import Receiver as JReceiver
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.spec import bch_spec
from dvbs2rx_tpu.tx import Transmitter, TxConfig

from dvbs2rx_tpu_torch.ops import bch, crc8_dev, demap
from dvbs2rx_tpu_torch.ops.ldpc import LDPCDecoder
from dvbs2rx_tpu_torch.ops.ldpc_cuda import CudaLDPCDecoder
from dvbs2rx_tpu_torch.rx.receiver import (
    FECStage,
    RxConfig,
    get_bch_decoder,
    get_ldpc_decoder,
)

torch.set_num_threads(2)
SHORT = ("short", 12, 7200, 7032)


def _bch_codewords(rng, n):
    framesize, t, nbch, kbch = SHORT
    out = []
    for _ in range(n):
        msg = rng.integers(0, 256, kbch // 8, dtype=np.uint8)
        parity = bch_spec.bch_encode_bytes(msg, framesize, t)
        out.append(np.concatenate([np.unpackbits(msg), np.unpackbits(parity)]))
    return np.stack(out)


@pytest.fixture(scope="module")
def bch_pair():
    return jbch.BCHDecoder(*SHORT), bch.BCHDecoder(*SHORT, device="cpu")


def test_bch_lane_major_mixed_batch_bit_exact(bch_pair):
    jdec, dec = bch_pair
    rng = np.random.default_rng(9)
    cw = _bch_codewords(rng, 6)
    bad = cw.copy()
    for b, n_err in enumerate([0, 1, 5, 12, 13, 30]):
        bad[b, rng.choice(SHORT[2], n_err, replace=False)] ^= 1
    want_t, want_n = jdec.decode_lane_major(jnp.asarray(bad.T.copy()))
    got_t, got_n = dec.decode_lane_major(torch.from_numpy(bad.T.copy()))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    n = got_n.numpy()
    assert list(n[:4]) == [0, 1, 5, 12] and (n[4:] == -1).all()
    np.testing.assert_array_equal(got_t.numpy()[:, :4], cw[:4].T)


def test_bch_call_and_all_clean_batch(bch_pair):
    jdec, dec = bch_pair
    rng = np.random.default_rng(4)
    cw = _bch_codewords(rng, 3)
    out, n = dec(torch.from_numpy(cw))
    np.testing.assert_array_equal(out.numpy(), cw)
    assert (n.numpy() == 0).all()
    bad = cw.copy()
    bad[1, rng.choice(SHORT[2], 7, replace=False)] ^= 1
    want, want_n = jdec(bad)
    got, got_n = dec(torch.from_numpy(bad))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_packet_validity_bit_exact():
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(1)
    pkts = rng.integers(0, 256, (200, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    frames = tx.bbframes(pkts.reshape(-1))[:4] ^ tx.bb_scramble
    frames = np.concatenate(
        [frames, rng.integers(0, 256, (2, frames.shape[1]), dtype=np.uint8)])
    want_ok, want_hdr = jcrc.packet_validity(jnp.asarray(frames))
    got_ok, got_hdr = crc8_dev.packet_validity(torch.from_numpy(frames))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_hdr.numpy(), np.asarray(want_hdr))
    assert got_hdr.numpy()[:4].all() and got_ok.numpy()[:4].any()


@pytest.mark.parametrize("const,rate", [("QPSK", "1/2"), ("8PSK", "3/5"),
                                        ("16APSK", "3/4")])
def test_demap_exact_int8(const, rate):
    rng = np.random.default_rng(2)
    syms = (rng.normal(size=(3, 540, 2)) * 0.8).astype(np.float32)
    n0 = np.asarray([0.05, 0.2, 0.7], np.float32)
    want = np.asarray(jdemap.demap(jnp.asarray(syms), jnp.asarray(n0),
                                   const, rate))
    got = demap.demap(torch.from_numpy(syms), torch.from_numpy(n0), const,
                      rate).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    vals = demap.demap(torch.from_numpy(syms), torch.from_numpy(n0), const,
                       rate, quantize=False)
    np.testing.assert_array_equal(demap.quantize_llrs(vals).numpy(), want)
    if const == "QPSK":
        w = np.asarray(jdemap.estimate_snr_qpsk(jnp.asarray(syms)))
        g = demap.estimate_snr_qpsk(torch.from_numpy(syms)).numpy()
    else:
        w = np.asarray(jdemap.estimate_snr_generic(jnp.asarray(syms), const,
                                                   rate))
        g = demap.estimate_snr_generic(torch.from_numpy(syms), const,
                                       rate).numpy()
    np.testing.assert_allclose(g, w, rtol=1e-5)


def test_quantize_rounds_half_to_even():
    vals = np.asarray([-128.6, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.5, 300.0],
                      np.float32)
    want = np.asarray(jdemap.quantize_llrs(jnp.asarray(vals)))
    got = demap.quantize_llrs(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fec_stage_kbytes_bit_exact():
    kw = dict(modcod="qpsk1/2", frame_size="short", ldpc_max_trials=10)
    jrx = JReceiver(JRxConfig(**kw))
    stage = FECStage(RxConfig(**kw), "cpu")
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(6)
    pkts = rng.integers(0, 256, (300, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    bb = tx.bbframes(pkts.reshape(-1))[:6]
    cw = np.stack([tx.fecframe_bits(f) for f in bb])
    llrs = np.where(cw == 0, 10, -10).astype(np.int8)
    flip = rng.random(llrs.shape) < np.asarray(
        [0.0, 0.01, 0.03, 0.05, 0.2, 0.0])[:, None]
    llrs = np.where(flip, -llrs, llrs).astype(np.int8)
    llrsT = np.ascontiguousarray(llrs.T)
    want = [np.asarray(x) for x in
            jrx._fec_stage_lane_major_impl(jnp.asarray(llrsT))]
    got = [x.numpy() for x in stage.lane_major(torch.from_numpy(llrsT))]
    got[2] = got[2].max()               # each frame's iterations
    for g, w, what in zip(got, want, ("kbytes", "n_corr", "iters", "ok",
                                      "hard_t")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    np.testing.assert_array_equal(got[0][:4], bb[:4])


@pytest.mark.parametrize("algo,update", [("min-sum", "normal"),
                                         ("offset-min-sum",
                                          "self-corrected")])
def test_fec_factories_share_decoders_and_refuse_other_rules(algo, update):
    """One decoder per code, rule and device, shared by every stage that
    decodes that code. Offset-min-sum with the normal update is the CUDA
    kernel's wrapper; every other rule is the plain decoder with that rule,
    as the JAX ``_make_ldpc_decoder`` sends it to its XLA path. A rule
    neither package knows is refused."""
    a = get_ldpc_decoder("S2_C4", 25, device="cpu")
    assert type(a) is CudaLDPCDecoder
    assert get_ldpc_decoder("S2_C4", 25, device=torch.device("cpu")) is a
    assert get_ldpc_decoder("S2_C5", 25, device="cpu") is not a
    assert get_ldpc_decoder("S2_C4", 4, device="cpu") is not a
    stage = FECStage(RxConfig(modcod="qpsk1/2", frame_size="short"), "cpu")
    assert stage.ldpc is a
    assert stage.bch is get_bch_decoder("short", 12, 7200, 7032, "cpu")
    v = get_ldpc_decoder("S2_C4", 25, algo, update, "cpu")
    assert type(v) is LDPCDecoder and (v.algo, v.update) == (algo, update)
    assert get_ldpc_decoder("S2_C4", 25, algo, update, "cpu") is v
    assert FECStage(RxConfig(modcod="qpsk1/2", frame_size="short",
                             ldpc_algo=algo, ldpc_update=update),
                    "cpu").ldpc is v
    with pytest.raises(ValueError, match="unknown LDPC"):
        get_ldpc_decoder("S2_C4", 25, algo + "-x", update, "cpu")
    with pytest.raises(ValueError, match="unknown LDPC"):
        get_ldpc_decoder("S2_C4", 25, "min-sum", update + "-x", "cpu")
