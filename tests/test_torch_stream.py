"""The port's stream receiver against the JAX ``StreamReceiver``.

Both receivers step from the same JAX-primed state (carried across with
``convert.state_from_numpy``) on the stimulus of ``tests/test_stream.py``
(C = 2 channels, F = 2 frames per step, T = 4 steps, short QPSK 1/2 at
15 dB), without CFO and with a small CFO (5e-6 per sample) and a 2-frame
coarse period, so the coarse estimate fires and the closed loop moves the
rotator. Integer outputs must match exactly; float statistics within
rtol 1e-4 (the float paths sum in another order than XLA on the CPU), with
an absolute floor for values that sit near zero.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import cplx as jcplx
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.stream import StreamEngine as JStreamEngine
from dvbs2rx_tpu.rx.stream import StreamReceiver as JStreamReceiver
from dvbs2rx_tpu.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch.convert import state_from_numpy, state_to_numpy
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import StreamEngine, StreamReceiver

torch.set_num_threads(2)

C, F, T = 2, 2, 4
EXACT = ("bch_errors", "ldpc_iters", "ts_ok", "hdr_ok", "fp", "locked",
         "sfill", "overflow", "underflow", "coarse_corrected")
# float stats: rtol 1e-4 plus an absolute floor scaled to each quantity
FLOAT_ATOL = {"metric": 1e-3, "n0": 1e-6, "snr_refined": 1e-2,
              "coarse_foffset": 1e-7, "fine_foffset": 1e-7,
              "cum_foffset": 1e-7}


def _cfgs(**extra):
    kw = dict(modcod="qpsk1/2", frame_size="short", sym_sync_impl="ffw",
              fec_batch=C * F, **extra)
    return JRxConfig(**kw), RxConfig(**kw)


def _stimulus(sr, n_steps, esn0_db=15.0, freq_offset=0.0, seed=0):
    txc = TxConfig(modcod="qpsk1/2", frame_size="short", pilots=False,
                   sps=2, rolloff=0.2)
    tx = Transmitter(txc)
    rng = np.random.default_rng(seed)
    need = sr._n_fe + n_steps * sr.n_in + 4096
    n_frames = need // (sr.frame_len * 2) + 4
    n_pkts = (n_frames * tx.df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq1 = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), esn0_db, sps=2,
                       freq_offset=freq_offset, seed=seed + 1)
    return np.stack([iq1] * sr.n_channels), pkts


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _cfgs()
    jsr = JStreamReceiver(jcfg, n_channels=C, frames_per_step=F)
    sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F, device="cpu")
    iq, pkts = _stimulus(jsr, T)
    return jsr, sr, iq, pkts


def _block(sr, iq, t):
    return jcplx.from_np(
        iq[:, sr._n_fe + t * sr.n_in: sr._n_fe + (t + 1) * sr.n_in]
    ).astype(np.float32)


def test_port_prime_matches_jax(pair):
    jsr, sr, iq, _ = pair
    jstate = {k: np.asarray(v) for k, v in jsr.prime(iq[:, : jsr._n_fe]).items()}
    state = state_to_numpy(sr.prime(iq[:, : sr._n_fe]))
    assert set(state) == set(jstate)
    np.testing.assert_array_equal(sr._first_sof, jsr._first_sof)
    for k, v in jstate.items():
        assert state[k].dtype == v.dtype, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(state[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(state[k], v, err_msg=k)


@pytest.mark.parametrize("freq_offset,coarse_period", [(0.0, 30),
                                                       (5e-6, 2)])
def test_port_steps_match_jax_from_same_state(pair, freq_offset,
                                              coarse_period):
    if coarse_period == 30:
        jsr, sr, iq, _ = pair
    else:
        jcfg, cfg = _cfgs(coarse_period=coarse_period)
        jsr = JStreamReceiver(jcfg, n_channels=C, frames_per_step=F)
        sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F,
                            device="cpu")
        iq, _ = _stimulus(jsr, T, freq_offset=freq_offset)
    jstate = jsr.prime(iq[:, : jsr._n_fe])
    state = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             "cpu")
    for t in range(T):
        blk = _block(sr, iq, t)
        jstate, jkb, jstats = jsr.step(jstate, jsr.put_iq(blk))
        state, kb, stats = sr.step(state, torch.from_numpy(blk))
        np.testing.assert_array_equal(kb.numpy(), np.asarray(jkb))
        for k in EXACT:
            np.testing.assert_array_equal(
                stats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
        for k, atol in FLOAT_ATOL.items():
            np.testing.assert_allclose(
                stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4,
                atol=atol, err_msg=k)
    assert bool(stats["locked"].all()) and int(stats["bch_errors"]) == 0
    # with CFO the closed loop has moved the rotator
    assert (float(stats["cum_foffset"][0]) != 0.0) == (freq_offset != 0.0)


def test_port_engine_ts_matches_jax(pair):
    jsr, _, iq, pkts = pair
    jcfg, cfg = _cfgs()
    n = jsr._n_fe + T * jsr.n_in
    jeng = JStreamEngine(jcfg, n_channels=C, frames_per_step=F)
    eng = StreamEngine(cfg, n_channels=C, frames_per_step=F, device="cpu")
    try:
        jts = jeng.receive(iq[:, :n])
        ts = eng.receive(iq[:, :n])
    finally:
        eng.close()
    for c in range(C):
        assert ts[c].size >= 188 * 10
        np.testing.assert_array_equal(ts[c], jts[c])
        o = ts[c].reshape(-1, 188)
        k = int(np.where((pkts == o[0]).all(axis=1))[0][0])
        np.testing.assert_array_equal(o, pkts[k: k + o.shape[0]])
    assert eng.stats.bch_frame_errors == 0
    assert eng.get_stats()["fec"]["frames"] == jeng.get_stats()["fec"]["frames"]


def test_port_reacquire_matches_jax(pair):
    """Device re-acquisition of one flagged channel from the latest n_fe
    raw samples, spliced into the carried state: integer leaves exact,
    float leaves within rtol 1e-4."""
    jsr, sr, iq, _ = pair
    jstate = jsr.prime(iq[:, : jsr._n_fe])
    state = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             "cpu")
    a = jsr._n_fe + jsr.n_in
    tail = jcplx.from_np(iq[:, a: a + jsr._n_fe]).astype(np.float32)
    mask = np.asarray([True, False])
    jnew, jok = jsr.reacquire(jstate, jsr.put_iq(tail), mask)
    new, ok = sr.reacquire(state, torch.from_numpy(tail),
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.numpy().tolist() == [True, False]
    back = state_to_numpy(new)
    for k, v in jnew.items():
        v = np.asarray(v)
        assert back[k].dtype == v.dtype, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(back[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
