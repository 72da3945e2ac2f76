"""The port's resamplers (``ops/resample.py``) and fractional-sps Tx
(``tx/transmitter.py``) against the JAX package's.

Identical (the same numpy code): the kernel designers, ``_rationalize``,
``_phase_taps``, ``StreamResampler`` chunked and flushed, the transmitter's
``TxConfig`` rules and ``StreamingChannel``. Within atol 1e-5 on
unit-variance input: ``DeviceResampler`` against JAX's and against
``StreamResampler`` (16-tap float32 sums in another order than XLA's
``einsum`` and numpy's complex64 ``einsum``). Within 1e-6: the port's
``Transmitter`` at sps 2.5, one shot and streamed.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import resample as jresample
from dvbs2rx_tpu.tx import Transmitter as JTransmitter
from dvbs2rx_tpu.tx import TxConfig as JTxConfig
from dvbs2rx_tpu.tx.transmitter import StreamingChannel as JStreamingChannel

from dvbs2rx_tpu_torch.ops import resample
from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig
from dvbs2rx_tpu_torch.tx.transmitter import StreamingChannel

torch.set_num_threads(2)


def noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def test_designers_match_jax():
    t = np.linspace(-9, 9, 1001)
    t[500] = 0.0
    for b in (0.2, 0.35, 0.25):
        t1 = np.append(t, [1 / (4 * b), -1 / (4 * b)])
        np.testing.assert_array_equal(resample.rrc_continuous(t1, b),
                                      jresample.rrc_continuous(t1, b))
        np.testing.assert_array_equal(resample.rrc_kernel(b, 25)(t1),
                                      jresample.rrc_kernel(b, 25)(t1))
    np.testing.assert_array_equal(resample.sinc_kernel(t, 0.3, 8),
                                  jresample.sinc_kernel(t, 0.3, 8))
    np.testing.assert_array_equal(resample._kaiser_continuous(t, 8, 4.0),
                                  jresample._kaiser_continuous(t, 8, 4.0))
    for ratio in (0.8, 1 / 1.7, 2.5, 1.25, 8001 / 2000):
        for md in (4096, 1 << 14):
            assert resample._rationalize(ratio, md) == \
                jresample._rationalize(ratio, md)
        P, Q = resample._rationalize(ratio, 4096)
        np.testing.assert_array_equal(
            resample._phase_taps(resample.lowpass_kernel(ratio, 8), P, Q, 8),
            jresample._phase_taps(jresample.lowpass_kernel(ratio, 8), P, Q,
                                  8))
    with pytest.raises(ValueError):
        resample._rationalize(0.0, 100)


@pytest.mark.parametrize("ratio", [1.25, 0.8, 2.5])
def test_stream_resampler_matches_jax(ratio):
    x = noise(5000, 3)
    cuts = [7, 500, 501, 2048]
    ours, theirs = resample.StreamResampler(ratio), \
        jresample.StreamResampler(ratio)
    a = [ours(c) for c in np.split(x, cuts)] + [ours.flush()]
    b = [theirs(c) for c in np.split(x, cuts)] + [theirs.flush()]
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("ratio", [0.8, 1 / 1.7])
def test_device_resampler_matches_jax_and_stream(ratio):
    x = noise(9000, 1)
    dev = resample.DeviceResampler(ratio, block_out=512, delay=8,
                                   device="cpu")
    jdev = jresample.DeviceResampler(ratio, block_out=512, delay=8)
    sr = resample.StreamResampler(ratio,
                                  kernel=resample.lowpass_kernel(ratio, 8),
                                  delay=8)
    assert (dev.P, dev.Q, dev.n_in, dev.n_out, dev.history) == \
        (jdev.P, jdev.Q, jdev.n_in, jdev.n_out, jdev.history)
    cuts = [1000, 1001, 5000]
    y = np.concatenate([dev(c) for c in np.split(x, cuts)] + [dev.flush()])
    jy = np.concatenate([jdev(c) for c in np.split(x, cuts)]
                        + [jdev.flush()])
    ys = np.concatenate([sr(x), sr.flush()])
    assert y.size == jy.size and y.size > 5000
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5)
    n = min(y.size, ys.size)
    np.testing.assert_allclose(y[:n], ys[:n], rtol=0, atol=1e-5)
    # reset by flush: the next stream starts from zeros again
    np.testing.assert_array_equal(
        np.concatenate([dev(x[:3000]), dev.flush()]),
        np.concatenate([dev(x[:3000]), dev.flush()]))


def test_txconfig_sps_rules_match_jax():
    for sps in (2, 2.0, 4, 2.5, 8001 / 2000):
        a, b = TxConfig(sps=sps), JTxConfig(sps=sps)
        assert a.sps == b.sps and type(a.sps) is type(b.sps)
    for bad in (0.5, 0.9):      # fractional sps must exceed 1
        for make in (TxConfig, JTxConfig):
            with pytest.raises(ValueError):
                make(sps=bad)


def test_fractional_transmitter_matches_jax():
    """Tx at sps 2.5: one shot, and symbols streamed in chunks through
    ``pulse_shape_stream`` + ``pulse_shape_flush`` (both sps kinds)."""
    kw = dict(modcod="qpsk1/2", frame_size="short", sps=2.5)
    tx, jtx = Transmitter(TxConfig(**kw)), JTransmitter(JTxConfig(**kw))
    rng = np.random.default_rng(4)
    pkts = rng.integers(0, 256, (3 * tx.df_bytes // 188, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq, jiq = tx.ts_to_iq(pkts.reshape(-1)), jtx.ts_to_iq(pkts.reshape(-1))
    assert iq.size == jiq.size
    np.testing.assert_allclose(iq, jiq, rtol=0, atol=1e-6)
    syms = tx.modulate_ts(pkts.reshape(-1))
    for sps in (2.5, 2):
        t = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short",
                                 sps=sps))
        jt = JTransmitter(JTxConfig(modcod="qpsk1/2", frame_size="short",
                                    sps=sps))
        parts = [t.pulse_shape_stream(c) for c in np.split(syms, [5, 4000])]
        parts.append(t.pulse_shape_flush())
        jparts = [jt.pulse_shape_stream(c) for c in np.split(syms, [5, 4000])]
        jparts.append(jt.pulse_shape_flush())
        streamed = np.concatenate(parts)
        np.testing.assert_allclose(streamed, np.concatenate(jparts), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(streamed, t.pulse_shape(syms), rtol=0,
                                   atol=1e-5)


def test_streaming_channel_matches_jax():
    iq = noise(6000, 9)
    kw = dict(esn0_db=8.0, sps=2.5, freq_offset=3e-4, phase=0.7, seed=12)
    ch, jch = StreamingChannel(**kw), JStreamingChannel(**kw)
    for c in np.split(iq, [1, 2500, 2501]):
        np.testing.assert_array_equal(ch(c), jch(c))
    quiet = StreamingChannel(sps=2)
    np.testing.assert_array_equal(quiet(iq), iq)
