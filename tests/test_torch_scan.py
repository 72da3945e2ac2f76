"""The port's chained scan step and its sync-free BCH.

- ``StreamReceiver.make_scan_step(4)`` against four of the port's own
  ``step`` calls from the same state: kbytes, state and every stats leaf
  bit-identical, the LDPC counters the scan sums over its steps equal to
  the steps' sum (the scan's CPU form is the same step with the BCH form
  that reads nothing back), and its kbytes against the JAX
  ``make_scan_step(4)`` exactly (the stimulus of ``tests/test_stream.py``:
  one channel, two short QPSK 1/2 frames per step, 15 dB).
- The sync-free BCH against the branching one on clean, correctable and
  uncorrectable frames: identical bits and correction counts, in both
  layouts and on an all-clean batch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvbs2rx_tpu.ops import cplx as jcplx
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.stream import StreamReceiver as JStreamReceiver
from dvbs2rx_tpu_torch.ops import bch
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import CALL_SUMS, ScanStep, StreamReceiver

from tests.test_stream import _stimulus
from tests.test_torch_fec import SHORT, _bch_codewords

torch.set_num_threads(2)

C, F, T = 1, 2, 4
KW = dict(modcod="qpsk1/2", frame_size="short", sym_sync_impl="ffw",
          fec_batch=C * F)


@pytest.fixture(scope="module")
def run():
    sr = StreamReceiver(RxConfig(**KW), n_channels=C, frames_per_step=F,
                        device="cpu")
    iq, _ = _stimulus(sr, T, seed=17)
    blks = np.stack([
        jcplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                         sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
        for t in range(T)])
    return sr, iq, blks


def test_scan_matches_stepwise_bit_for_bit(run):
    sr, iq, blks = run
    state = sr.prime(iq[:, : sr._n_fe])
    steps = []
    for t in range(T):
        state, kb, stats = sr.step(state, torch.from_numpy(blks[t]))
        steps.append((kb, stats))
    scan = sr.make_scan_step(T)
    assert isinstance(scan, ScanStep)
    state2, kbs, sstats = scan(sr.prime(iq[:, : sr._n_fe]), blks)
    assert kbs.shape == (T, C, F, sr.fec.cfg.fec.kbch // 8)
    for t, (kb, stats) in enumerate(steps):
        assert torch.equal(kbs[t], kb)
        assert set(sstats) == set(stats)
        for k, v in stats.items():
            if k in CALL_SUMS:
                continue
            assert sstats[k].shape == (T,) + v.shape, k
            assert torch.equal(sstats[k][t], v), k
    # the LDPC counters: one scalar a call, the steps' sum
    for k in CALL_SUMS:
        want = torch.stack([st[k] for _, st in steps]).sum(dtype=torch.int32)
        assert sstats[k].shape == () and torch.equal(sstats[k], want), k
    for k, v in state.items():
        assert torch.equal(state2[k], v), k
    assert bool(sstats["locked"][-1].all())
    assert int(sstats["bch_errors"].sum()) == 0
    with pytest.raises(ValueError, match="expected"):
        scan(state2, blks[:2])


def test_scan_kbytes_match_the_jax_scan(run):
    sr, iq, blks = run
    jsr = JStreamReceiver(JRxConfig(**KW), n_channels=C, frames_per_step=F)
    jstate, jkbs, jstats = jsr.make_scan_step(T)(
        jsr.prime(iq[:, : jsr._n_fe]), jnp.asarray(blks))
    _, kbs, stats = sr.make_scan_step(T)(sr.prime(iq[:, : sr._n_fe]), blks)
    np.testing.assert_array_equal(kbs.numpy(), np.asarray(jkbs))
    for k in ("bch_errors", "ldpc_iters", "fp", "locked", "ts_ok",
              "hdr_ok", "sfill"):
        np.testing.assert_array_equal(stats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)
    np.testing.assert_allclose(stats["metric"].numpy(),
                               np.asarray(jstats["metric"]), rtol=1e-4,
                               atol=1e-3)


@pytest.fixture(scope="module")
def frames():
    """Six short BCH codewords with 0, 1, 5, 12 (= t), 13 and 30 errors."""
    rng = np.random.default_rng(21)
    cw = _bch_codewords(rng, 6)
    bad = cw.copy()
    for b, n_err in enumerate([0, 1, 5, 12, 13, 30]):
        bad[b, rng.choice(SHORT[2], n_err, replace=False)] ^= 1
    return cw, bad


@pytest.mark.parametrize("layout", ["rows", "lane_major"])
def test_sync_free_bch_equals_the_branching_bch(frames, layout):
    cw, bad = frames
    dec = bch.BCHDecoder(*SHORT, device="cpu")
    for x in (bad, cw):        # mixed, then an all-clean batch
        if layout == "rows":
            a = dec(torch.from_numpy(x))
            b = dec(torch.from_numpy(x), sync_free=True)
        else:
            xt = torch.from_numpy(x.T.copy())
            a = dec.decode_lane_major(xt)
            b = dec.decode_lane_major(xt, sync_free=True)
        assert torch.equal(a[0], b[0])
        assert torch.equal(a[1], b[1])
        assert b[1].dtype == torch.int32
    n = b[1].numpy()
    assert (n == 0).all()
    n = dec(torch.from_numpy(bad), sync_free=True)[1].numpy()
    assert list(n[:4]) == [0, 1, 5, 12] and (n[4:] == -1).all()


def test_xor_tree_equals_the_running_xor():
    rng = np.random.default_rng(3)
    for w in (1, 2, 3, 7, 25, 32, 33):
        x = torch.from_numpy(rng.integers(0, 1 << 16, (5, w)))
        want = x[:, 0].clone()
        for j in range(1, w):
            want ^= x[:, j]
        assert torch.equal(bch._xor_reduce(x), want), w
