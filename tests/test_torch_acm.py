"""The port's host ``ACMReceiver`` against the JAX ``ACMReceiver``.

Stimulus: the JAX package's ``VCMTransmitter`` over short QPSK 1/2 (PLS
16, or 17 with pilots) and 8PSK 3/5 (PLS 48 / 49) frames, with dummy frames
where a schedule has -1, 12-16 frames of numpy-seeded packets, AWGN (and a
CFO where a case says so) from ``awgn_channel`` with a fixed seed. Both
receivers run on the CPU through ``make_receiver`` with ``acm_vcm=True``,
``fec_batch`` 4 and ``frame_group`` 4.

Exact: TS bytes, every integer ``RxStats`` and ``BBFrameStats`` counter,
the per-PLS counters of ``get_stats`` (frames, FEC frames and errors, LDPC
trials). Within rtol 1e-4 (absolute floors 1e-7 for the offsets, 1e-3 dB
for SNRs): ``snr_db``, the frequency offsets and the per-PLS SNR and fine
offset. ``derotate_plheader`` with per-channel tensor arguments is held to
the JAX function called per channel with scalars (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import plsync as jplsync
from dvbs2rx_tpu.rx.receiver import ACMReceiver as JACMReceiver
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.tx import TxConfig, awgn_channel
from dvbs2rx_tpu.tx.vcm import VCMTransmitter

from dvbs2rx_tpu_torch.ops import plsync
from dvbs2rx_tpu_torch.rx.receiver import ACMReceiver, RxConfig, make_receiver
from dvbs2rx_tpu_torch.spec.pls import make_pls

from tests.test_torch_receiver import assert_consecutive, assert_same_stats

torch.set_num_threads(2)

QPSK = make_pls(4, True, False)          # 16: qpsk1/2 short
PSK8 = make_pls(12, True, False)         # 48: 8psk3/5 short


def vcm_stimulus(schedule, n_frames=12, esn0=14.0, seed=0, freq_offset=0.0,
                 pilots=False):
    """(iq, packets, frame kinds): a VCM waveform of about ``n_frames``
    data frames; ``kinds`` lists each frame's schedule entry (-1 dummy)."""
    txs = [TxConfig(modcod="qpsk1/2", frame_size="short", pilots=pilots),
           TxConfig(modcod="8psk3/5", frame_size="short", pilots=pilots)]
    vtx = VCMTransmitter(txs)
    data = [s for s in schedule if s >= 0]
    per = sum(vtx.txs[s].df_bytes for s in data) / len(data)
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (int(n_frames * per) // 188, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    kinds, k, pos = [], 0, 0
    while True:
        sel = schedule[k % len(schedule)]
        k += 1
        if sel < 0:
            kinds.append(-1)
            continue
        if pkts.size - pos < vtx.txs[sel].df_bytes:
            break
        pos += vtx.txs[sel].df_bytes
        kinds.append(sel)
    iq = awgn_channel(vtx.ts_to_iq(pkts.reshape(-1), schedule), esn0, sps=2,
                      freq_offset=freq_offset, seed=seed + 1)
    return iq, pkts, kinds


def assert_same_per_pls(rx, jrx):
    ours, theirs = rx.get_stats(), jrx.get_stats()
    for sec in ("plsync", "fec"):
        assert sorted(ours[sec]["per_pls"]) == sorted(theirs[sec]["per_pls"])
        for pls, v in theirs[sec]["per_pls"].items():
            w = ours[sec]["per_pls"][pls]
            for k, x in v.items():
                if k == "snr" and x is not None:
                    np.testing.assert_allclose(w[k], x, rtol=1e-4, atol=1e-3)
                elif k == "fine_foffset":
                    np.testing.assert_allclose(w[k], x, rtol=1e-4, atol=1e-7)
                else:
                    assert w[k] == x, (sec, pls, k)


def acm_pair(schedule, calls=1, stim=None, **rx_kw):
    """Run the JAX and the port ACM receiver on one stimulus; returns (port
    receiver, JAX receiver, port TS, JAX TS, packets, kinds)."""
    stim = dict(stim or {})
    iq, pkts, kinds = vcm_stimulus(schedule, **stim)
    kw = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
              fec_batch=4, pilots=stim.get("pilots", False), **rx_kw)
    jrx = JACMReceiver(JRxConfig(**kw))
    rx = make_receiver(RxConfig(**kw), device="cpu")
    assert type(rx) is ACMReceiver
    outs = []
    for r in (rx, jrx):
        parts = np.array_split(iq, calls)
        outs.append(np.concatenate(
            [r.receive(p, flush=i == calls - 1) for i, p in enumerate(parts)]))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert_same_stats(rx, jrx)
    assert_same_per_pls(rx, jrx)
    return rx, jrx, outs[0], outs[1], pkts, kinds


def test_two_modcods_with_dummies_match_jax():
    """QPSK and 8PSK frames with a dummy frame between them, fed in two
    calls: every dummy after the lock is counted (the last frame has no
    next header and is not walked), both PLS decode, the TS is a
    consecutive run of the input."""
    rx, jrx, ts, _, pkts, kinds = acm_pair([0, -1, 1], calls=2,
                                           stim=dict(seed=3))
    st = rx.stats
    walked = st.frame_cnt + st.dummy_cnt + st.rejected_cnt
    k0 = len(kinds) - 1 - walked
    assert 0 <= k0 <= 3
    assert st.dummy_cnt == kinds[k0:-1].count(-1) >= 3
    assert st.bch_frame_errors == 0 and st.rejected_cnt == 0
    assert set(rx.get_stats()["fec"]["per_pls"]) == {QPSK, PSK8}
    assert_consecutive(ts, pkts, 40)


def test_pls_list_rejects_the_other_modcod_like_jax():
    rx, *_ = acm_pair([0, 1], pls_list=(QPSK,), stim=dict(seed=5))
    assert rx.stats.rejected_cnt >= 4 and rx.stats.frame_cnt >= 4
    assert set(rx.get_stats()["fec"]["per_pls"]) == {QPSK}
    assert rx.stats.bch_frame_errors == 0


def test_pls_expected_restricts_the_search_like_jax():
    rx, _, ts, _, pkts, _ = acm_pair([0, 1], pls_expected=(QPSK, PSK8),
                                     stim=dict(seed=7))
    mask = rx._plsc_search_mask
    assert mask.sum() == 6 and mask[[0, 1, 2, 3, QPSK, PSK8]].all()
    assert rx.stats.bch_frame_errors == 0
    assert_consecutive(ts, pkts, 40)


def test_open_loop_derotation_matches_jax():
    """closed_loop=False: no rotator correction at all; each PLHEADER is
    derotated by the latest coarse, then fine, estimate before its PLSC
    decode (a small CFO inside the fine range)."""
    rx, *_ = acm_pair([0], closed_loop=False, coarse_period=4,
                      stim=dict(pilots=True, esn0=12.0, freq_offset=1e-4,
                                seed=45, n_frames=14))
    assert rx.stats.coarse_corrected and rx._fine_ready
    assert rx.stats.cum_freq_offset == 0.0
    assert rx._derot_params()[1] and rx._derot_params()[0] != 0.0


@pytest.mark.parametrize("mode", ["coherent-hard", "differential"])
def test_plsc_modes_match_jax(mode):
    rx, _, ts, _, pkts, _ = acm_pair([0, 1], plsc_mode=mode,
                                     stim=dict(seed=11))
    assert rx.stats.bch_frame_errors == 0 and rx.stats.frame_cnt >= 8
    assert_consecutive(ts, pkts, 40)


def test_weak_header_fallback_matches_jax():
    """A PLHEADER whose timing metric falls below the locked threshold is
    decoded on its own in the chain walk (``tests/test_acm_vcm.py``'s
    attenuated fourth header)."""
    iq, pkts, _ = vcm_stimulus([0], seed=31)
    L = 8190
    iq = iq.copy()
    iq[2 * 3 * L: 2 * 3 * L + 2 * 135] *= 0.5
    kw = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
              fec_batch=4)
    jrx = JACMReceiver(JRxConfig(**kw))
    rx = ACMReceiver(RxConfig(**kw), device="cpu")
    calls = []
    orig = rx._call
    rx._call = lambda key, fn, args: calls.append(key[0]) or orig(key, fn,
                                                                   args)
    ts, jts = rx.receive(iq), jrx.receive(iq)
    np.testing.assert_array_equal(ts, jts)
    assert_same_stats(rx, jrx)
    assert "plsc1" in calls
    assert rx.stats.bch_frame_errors == 0 and rx.stats.locked
    assert_consecutive(ts, pkts, 40)


def _headers(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 90, 2)) * 0.7).astype(np.float32)


def test_derotate_plheader_per_channel_tensors_match_jax():
    """(C,) tensors of foffset and apply_freq against the JAX function
    called per channel with scalars, for one header per channel and for C x
    K candidate headers."""
    C, K = 3, 5
    hdr = _headers(C * K, 2).reshape(C, K, 90, 2)
    foff = np.asarray([3e-3, -1e-3, 2e-4], np.float32)
    apply = np.asarray([True, False, True])
    got = plsync.derotate_plheader(torch.from_numpy(hdr),
                                   torch.from_numpy(foff)[:, None],
                                   torch.from_numpy(apply)[:, None]).numpy()
    one = plsync.derotate_plheader(torch.from_numpy(hdr[:, 0]),
                                   torch.from_numpy(foff),
                                   torch.from_numpy(apply)).numpy()
    for c in range(C):
        want = np.asarray(jplsync.derotate_plheader(hdr[c], foff[c],
                                                    bool(apply[c])))
        np.testing.assert_allclose(got[c], want, rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(one[c], want[0], rtol=1e-5, atol=2e-6)
        scalar = plsync.derotate_plheader(torch.from_numpy(hdr[c]),
                                          float(foff[c]), bool(apply[c]))
        np.testing.assert_array_equal(got[c], scalar.numpy())
