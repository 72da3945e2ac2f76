"""The port's host CCM ``Receiver`` (``make_receiver``) against the JAX one.

Stimulus: the JAX package's transmitter, short FECFRAMEs (QPSK 1/2 unless
a case says otherwise), 10 frames of numpy-seeded packets, AWGN (and a CFO
where a case says so) from ``awgn_channel`` with a fixed seed. Both
receivers run on the CPU at ``fec_batch`` 4 and ``frame_group`` 4 with the
CLI's other defaults (``frontend_block`` 4096, feed-forward timing).

Exact: the TS bytes (the BBFRAME bytes with ``out_stream="bb"``), every
integer ``RxStats`` and ``BBFrameStats`` counter and the lock state. Within
rtol 1e-4, with absolute floors of 1e-7 for the frequency offsets and 1e-3
dB for the SNR: ``snr_db``, ``cum_freq_offset`` and the fine and coarse
offsets (float32 sums in another order than XLA's on the CPU).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.rx.receiver import Receiver as JReceiver
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch.convert import (
    ffsync_state_from_numpy,
    ffsync_state_to_numpy,
    refined_n0_from_numpy,
)
from dvbs2rx_tpu_torch.rx.receiver import (
    ACMReceiver,
    Receiver,
    RxConfig,
    RxStats,
    make_receiver,
)

torch.set_num_threads(2)

INT_STATS = ("locked", "sof_cnt", "frame_cnt", "rejected_cnt", "dummy_cnt",
             "lock_cnt", "unlock_cnt", "coarse_corrected", "ldpc_frames",
             "ldpc_total_iters", "bch_frames", "bch_frame_errors",
             "bch_corrections")
FLOAT_ATOL = {"coarse_foffset": 1e-7, "fine_foffset": 1e-7,
              "cum_freq_offset": 1e-7, "snr_db": 1e-3}


def stimulus(modcod="qpsk1/2", pilots=False, esn0=8.0, freq_offset=0.0,
             n_frames=10, seed=0):
    """(iq, packets) of ``n_frames`` short frames of one MODCOD."""
    tx = Transmitter(TxConfig(modcod=modcod, frame_size="short",
                              pilots=pilots))
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (n_frames * tx.df_bytes // 188, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), esn0, sps=2,
                      freq_offset=freq_offset, seed=seed + 1)
    return iq, pkts


def assert_same_stats(rx, jrx):
    """Integer counters equal, float statistics within the stated
    tolerances, the TS stitcher's counters and the nested ``get_stats``
    equal (its float entries within the same tolerances)."""
    for k in INT_STATS:
        assert getattr(rx.stats, k) == getattr(jrx.stats, k), k
    for k, atol in FLOAT_ATOL.items():
        np.testing.assert_allclose(getattr(rx.stats, k),
                                   getattr(jrx.stats, k), rtol=1e-4,
                                   atol=atol, err_msg=k)
    assert dataclasses.asdict(rx.bb_parser.stats) == \
        dataclasses.asdict(jrx.bb_parser.stats)
    ours, theirs = rx.get_stats(), jrx.get_stats()
    for sec in ("fec", "bbframes", "mpeg-ts"):
        for k, v in theirs[sec].items():
            if k in ("per_pls", "fer", "per", "avg_ldpc_trials"):
                continue
            assert ours[sec][k] == v, (sec, k)
    pl = {k: v for k, v in theirs["plsync"].items()
          if k not in ("freq_offset_norm", "locked_since", "per_pls")}
    assert {k: ours["plsync"][k] for k in pl} == pl


def assert_consecutive(out, pkts, min_pkts):
    """The output is a consecutive bit-exact run of the input packets."""
    o = out.reshape(-1, 188)
    assert o.shape[0] >= min_pkts, o.shape[0]
    k = int(np.where((pkts == o[0]).all(axis=1))[0][0])
    np.testing.assert_array_equal(o, pkts[k: k + o.shape[0]])


def _pair(calls=1, tx=None, **rx_kw):
    """Run the JAX and the port receiver on one stimulus, in ``calls``
    ``receive`` calls (flushing with the last). Returns (port receiver,
    JAX receiver, port output, JAX output, packets)."""
    tx = dict(tx or {})
    modcod = tx.pop("modcod", "qpsk1/2")
    kw = dict(modcod=modcod, frame_size="short", fec_batch=4,
              pilots=tx.get("pilots", False), **rx_kw)
    iq, pkts = stimulus(modcod=modcod, **tx)
    jrx = JReceiver(JRxConfig(**kw))
    rx = make_receiver(RxConfig(**kw), device="cpu")
    assert type(rx) is Receiver
    outs = []
    for r in (rx, jrx):
        parts = np.array_split(iq, calls)
        outs.append(np.concatenate(
            [r.receive(p, flush=i == calls - 1) for i, p in enumerate(parts)]))
    return rx, jrx, outs[0], outs[1], pkts


CASES = {
    "noisy": dict(tx=dict(esn0=7.0)),
    "clean_instant_agc": dict(tx=dict(esn0=40.0), agc_rate=1.0),
    "pilots": dict(tx=dict(pilots=True, esn0=8.0)),
    "cfo_closed_loop": dict(tx=dict(esn0=12.0, freq_offset=1e-5),
                            coarse_period=2),
    "8psk": dict(tx=dict(modcod="8psk3/5", esn0=13.0)),
    "two_calls": dict(tx=dict(esn0=8.0, seed=5), calls=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_receiver_matches_jax(case):
    rx, jrx, ts, jts, pkts = _pair(**CASES[case])
    np.testing.assert_array_equal(ts, jts)
    assert_same_stats(rx, jrx)
    assert rx.stats.locked and rx.stats.bch_frame_errors == 0
    assert rx.stats.frame_cnt >= 8
    assert_consecutive(ts, pkts, 25)
    if case == "cfo_closed_loop":
        # the coarse estimate fired and the closed loop moved the rotator
        assert rx.stats.coarse_corrected and rx.stats.cum_freq_offset != 0
        assert rx._rot_inc != 0


def test_bb_output_matches_jax():
    """``out_stream="bb"``: the descrambled BBFRAMEs, byte for byte, and no
    TS stitch (its counters stay zero in both)."""
    rx, jrx, bb, jbb, pkts = _pair(tx=dict(esn0=8.0), out_stream="bb")
    np.testing.assert_array_equal(bb, jbb)
    assert_same_stats(rx, jrx)
    kb = rx.cfg.fec.kbch // 8
    assert bb.size == kb * rx.stats.bch_frames and bb.size > 0
    assert rx.bb_parser.stats.bbframe_cnt == 0
    # a BBFRAME's data field carries the packets after the 10-byte header
    frames = bb.reshape(-1, kb)
    assert (frames[:, 9] != 0).any() or (frames[:, :2] != 0).any()


def test_default_agc_gain_matches_jax():
    """The default slow AGC (rate 1e-5 per sample, a per-block smoothing
    factor of rate x block samples) carries the same gain."""
    rx, jrx, ts, jts, _ = _pair(tx=dict(esn0=9.0), agc_gain=0.5)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(rx._agc_gain, jrx._agc_gain, rtol=1e-5)
    assert rx._agc_gain != 0.5


HOST_ATTRS = ("_samp_buf", "_sym_buf", "_agc_gain", "_rot_phase", "_rot_inc",
              "_lock_state", "_frame_phase", "_unlock_cnt", "_coarse_acc",
              "_coarse_frames", "_coarse_foffset", "_coarse_corrected",
              "_fine_foffset", "_cum_foffset", "_settle_frames", "_n0")


def take_over(rx, jrx):
    """Start the port receiver ``rx`` from the JAX receiver's state: its
    host attributes and TS stitcher as they are, the device parts (the
    timing state and the refined N0) through ``convert``, its FEC queue
    row by row."""
    for a in HOST_ATTRS:
        setattr(rx, a, copy.deepcopy(getattr(jrx, a)))
    rx.stats = RxStats(**dataclasses.asdict(jrx.stats))
    rx._ss_state = ffsync_state_from_numpy(
        {k: np.asarray(getattr(jrx._ss_state, k))
         for k in ("tau", "rate", "initialized")}, rx.device)
    rx._n0_refined = refined_n0_from_numpy(
        {rx.cfg.pls: jrx._n0_refined})[rx.cfg.pls]
    rx._llr_queue = [torch.from_numpy(np.array(x)) for x in jrx._llr_queue]
    rx._xfec_queue = [torch.from_numpy(np.array(x)) for x in jrx._xfec_queue]
    rx.bb_parser.synched = jrx.bb_parser.synched
    rx.bb_parser.partial = jrx.bb_parser.partial.copy()
    for k, v in dataclasses.asdict(jrx.bb_parser.stats).items():
        setattr(rx.bb_parser.stats, k, v)


def test_continues_from_the_jax_receivers_state():
    """The port takes over the JAX receiver mid-stream (after a CFO moved
    its rotator and with FEC frames queued) and both finish the stream
    alike."""
    kw = dict(modcod="qpsk1/2", frame_size="short", fec_batch=4,
              coarse_period=2)
    iq, pkts = stimulus(esn0=12.0, freq_offset=1e-5, seed=9, n_frames=14)
    cut = iq.size * 3 // 4
    jrx = JReceiver(JRxConfig(**kw))
    first = jrx.receive(iq[:cut], flush=False)
    assert jrx._rot_inc != 0 and jrx._n0_refined is not None
    rx = Receiver(RxConfig(**kw), device="cpu")
    take_over(rx, jrx)
    back = ffsync_state_to_numpy(rx._ss_state)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrx._ss_state,
                                                            k)))
    ts = rx.receive(iq[cut:])
    jts = jrx.receive(iq[cut:])
    np.testing.assert_array_equal(ts, jts)
    assert_same_stats(rx, jrx)
    assert_consecutive(np.concatenate([first, ts]), pkts, 25)


def test_refined_n0_conversion():
    assert refined_n0_from_numpy({17: None, 49: np.float32(0.25)}) == \
        {17: 0.0, 49: 0.25}


def test_gardner_sync_is_not_ported():
    """The Gardner loop raises, naming the roadmap; an unknown timing
    implementation is a ValueError, as in the JAX receiver."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Receiver(RxConfig(modcod="qpsk1/2", frame_size="short",
                          sym_sync_impl="gardner"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_receiver(RxConfig(modcod="qpsk1/2", frame_size="short",
                               acm_vcm=True, sym_sync_impl="gardner"),
                      device="cpu")
    with pytest.raises(ValueError, match="sym_sync_impl"):
        Receiver(RxConfig(modcod="qpsk1/2", frame_size="short",
                          sym_sync_impl="nope"), device="cpu")


def test_make_receiver_routes_and_defaults_to_the_card():
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", acm_vcm=True)
    assert type(make_receiver(cfg, device="cpu")) is ACMReceiver
    with pytest.raises(ValueError, match="acm_vcm"):
        ACMReceiver(RxConfig(modcod="qpsk1/2", frame_size="short"),
                    device="cpu")
    if torch.cuda.is_available():
        assert make_receiver(cfg).device.type == "cuda"
        return
    for c in (cfg, RxConfig(modcod="qpsk1/2", frame_size="short")):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            make_receiver(c)
