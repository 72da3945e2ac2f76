"""The host receivers with Gardner timing, and the ``ffw`` receiver behind
the port's ``DeviceResampler``, against the same JAX chains.

Stimulus: the JAX package's transmitter, 5-6 short FECFRAMEs of
numpy-seeded packets, a fractional timing offset (linear interpolation
between neighbouring samples), AWGN from ``awgn_channel`` with a fixed
seed. Both receivers run on the CPU (the port's Gardner loop is its plain
version there) at ``fec_batch`` 4 and ``frame_group`` 4.

Exact: TS bytes, every integer ``RxStats`` and ``BBFrameStats`` counter
and the nested ``get_stats`` (floats within the tolerances of
``tests/test_torch_receiver.py``: float32 sums in another order than
XLA's outside the timing loop).
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops.resample import DeviceResampler as JDeviceResampler
from dvbs2rx_tpu.rx.receiver import ACMReceiver as JACMReceiver
from dvbs2rx_tpu.rx.receiver import Receiver as JReceiver
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch.ops.frontend import SymbolSync
from dvbs2rx_tpu_torch.ops.resample import DeviceResampler
from dvbs2rx_tpu_torch.rx.acm_batch import BatchedACMReceiver
from dvbs2rx_tpu_torch.rx.receiver import Receiver, RxConfig, make_receiver

from tests.test_torch_acm import acm_pair, vcm_stimulus
from tests.test_torch_cuda import (
    GARDNER_CCM_PACKETS,
    GARDNER_CCM_RX,
    gardner_ccm_iq,
)
from tests.test_torch_receiver import (
    INT_STATS,
    assert_consecutive,
    assert_same_stats,
)

torch.set_num_threads(2)


def ccm_stimulus(sps, n_frames=5, esn0=9.0, seed=0, delay=0.4):
    """(iq, packets): short QPSK 1/2 frames at ``sps`` (may be fractional)
    delayed by ``delay`` of a sample."""
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short", sps=sps))
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (n_frames * tx.df_bytes // 188, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    clean = tx.ts_to_iq(pkts.reshape(-1))
    shifted = (clean[1:] * (1 - delay) + clean[:-1] * delay).astype(
        np.complex64)
    return awgn_channel(shifted, esn0, sps=sps, seed=seed + 1), pkts


@pytest.mark.parametrize("sps", [2, 4])
def test_gardner_receiver_matches_jax(sps):
    """``Receiver`` with Gardner timing at sps 2 and 4, in two calls."""
    iq, pkts = ccm_stimulus(sps, seed=sps)
    kw = dict(modcod="qpsk1/2", frame_size="short", fec_batch=4, sps=sps,
              sym_sync_impl="gardner")
    rx = make_receiver(RxConfig(**kw), device="cpu")
    assert type(rx) is Receiver and isinstance(rx.sym_sync, SymbolSync)
    jrx = JReceiver(JRxConfig(**kw))
    outs = []
    for r in (rx, jrx):
        cut = iq.size // 2
        outs.append(np.concatenate([r.receive(iq[:cut], flush=False),
                                    r.receive(iq[cut:])]))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert_same_stats(rx, jrx)
    assert rx.stats.locked and rx.stats.bch_frame_errors == 0
    assert_consecutive(outs[0], pkts, 10)


def test_gardner_card_stimulus_matches_jax():
    """The IQ of the on-card Gardner receiver test (``test_torch_cuda.py``,
    made by the port's transmitter): the port on the CPU and the JAX
    ``Receiver`` give the same TS and stats, the first GARDNER_CCM_PACKETS
    packets sent, which the on-card test holds the card to. The port's
    ``ffw`` receiver gives the same packets: the two frames lost are the
    stream's tail, not the Gardner loop's."""
    iq, pkts = gardner_ccm_iq()
    rx = make_receiver(RxConfig(**GARDNER_CCM_RX), device="cpu")
    jrx = JReceiver(JRxConfig(**GARDNER_CCM_RX))
    ts, jts = rx.receive(iq), jrx.receive(iq)
    np.testing.assert_array_equal(ts, jts)
    assert_same_stats(rx, jrx)
    np.testing.assert_array_equal(jts.reshape(-1, 188),
                                  pkts[:GARDNER_CCM_PACKETS])
    assert jrx.stats.bch_frame_errors == 0
    ffw_cfg = RxConfig(**{**GARDNER_CCM_RX, "sym_sync_impl": "ffw"})
    ffw = make_receiver(ffw_cfg, device="cpu")
    np.testing.assert_array_equal(ffw.receive(iq), jts)


def test_gardner_acm_receiver_matches_jax():
    """Blind ``ACMReceiver`` (no PLS set known) with Gardner timing on QPSK
    and 8PSK frames with a dummy frame between them."""
    rx, _, ts, _, pkts, _ = acm_pair(
        [0, -1, 1], stim=dict(seed=13, n_frames=6),
        sym_sync_impl="gardner")
    assert isinstance(rx.sym_sync, SymbolSync)
    assert rx.stats.bch_frame_errors == 0 and rx.stats.frame_cnt >= 3
    assert rx.stats.dummy_cnt >= 1
    assert_consecutive(ts, pkts, 20)


def test_gardner_batched_acm_matches_singles():
    """``BatchedACMReceiver`` with Gardner timing, C = 2: each channel
    equals a single JAX ``ACMReceiver`` on it, and every front-end group
    ran as one call of both channels (padded where a channel had no
    request, as ``BatchedACMReceiver`` pads every group)."""
    stims = [vcm_stimulus([0, 1], n_frames=5, seed=30 + 2 * c)
             for c in range(2)]
    n = min(s[0].size for s in stims)
    iq = np.stack([s[0][:n] for s in stims])
    kw = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
              fec_batch=4, sym_sync_impl="gardner")
    brx = BatchedACMReceiver(RxConfig(**kw), 2, device="cpu")
    groups, calls = [], []
    orig = brx._batch_call

    def batch_call(fn, args_list):
        if fn.__name__ != "_fe_batch":
            return orig(fn, args_list)
        groups.append(len(args_list))

        def fe(reqs):
            calls.append(len(reqs))
            return fn(reqs)

        return orig(fe, args_list)

    brx._batch_call = batch_call
    ts = brx.receive(iq)
    # a group is one call padded to both channels; most hold both requests
    assert set(calls) == {2} and len(calls) == len(groups)
    assert groups.count(2) > len(groups) // 2
    for c in range(2):
        jrx = JACMReceiver(JRxConfig(**kw))
        np.testing.assert_array_equal(ts[c], jrx.receive(iq[c]),
                                      err_msg=f"channel {c}")
        for k in INT_STATS:
            assert getattr(brx.chans[c].stats, k) == \
                getattr(jrx.stats, k), (c, k)
        assert brx.chans[c].stats.bch_frame_errors == 0
        assert_consecutive(ts[c], stims[c][1], 10)


def test_resampled_ffw_receiver_matches_jax():
    """Tx at 2.5 samples per symbol -> ``DeviceResampler(0.8)`` -> the
    ``ffw`` receiver at sps 2, against the JAX resampler and receiver
    (``tests/test_resample.py::test_loopback_fractional_sps``)."""
    iq, pkts = ccm_stimulus(2.5, n_frames=6, esn0=15.0, seed=7, delay=0.0)
    dev = DeviceResampler(0.8, block_out=8192, delay=8, device="cpu")
    jdev = JDeviceResampler(0.8, block_out=8192, delay=8)
    iq2 = np.concatenate([dev(iq), dev.flush()])
    jiq2 = np.concatenate([jdev(iq), jdev.flush()])
    np.testing.assert_allclose(iq2, jiq2, rtol=0, atol=1e-5)
    kw = dict(modcod="qpsk1/2", frame_size="short", fec_batch=4)
    rx = Receiver(RxConfig(**kw), device="cpu")
    jrx = JReceiver(JRxConfig(**kw))
    ts, jts = rx.receive(iq2), jrx.receive(jiq2)
    np.testing.assert_array_equal(ts, jts)
    assert_same_stats(rx, jrx)
    assert rx.stats.bch_frame_errors == 0
    assert_consecutive(ts, pkts, 12)
