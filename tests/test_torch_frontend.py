"""The port's front end against the JAX package.

- ``FeedForwardSync``: the tracker (``_track`` against the vmapped JAX
  ``_track_impl``) and ``step_batched``, on a Tx waveform with a
  fractional delay, from initialised and fresh states whose positions and
  rates force slips both ways. Exact: ``consumed``, ``off_seg`` and the
  selected subfilter taps; ``tau``/``rate`` within rtol 1e-5; symbols
  within atol 1e-4. Covers the multi-window (n >= 16384), single-window and
  one-segment (``mf_decimate``) paths.
- ``rotate_block``: atol 1e-5 (float32 cos/sin of the same phases), against
  the jitted JAX function (XLA contracts its phase into an FMA).
- ``plsync.timing_metric``: rtol 1e-5 plus atol 1e-4 on metric values up to
  ~57 (57 taps summed in the JAX order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvbs2rx_tpu.ops import plsync as jplsync
from dvbs2rx_tpu.ops.ffsync import FeedForwardSync as JFFSync
from dvbs2rx_tpu.ops.ffsync import FFSyncState as JFFState
from dvbs2rx_tpu.ops.frontend import rotate_block as j_rotate_block
from dvbs2rx_tpu.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch.ops import cplx, plsync
from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync, FFSyncState
from dvbs2rx_tpu_torch.ops.frontend import rotate_block

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def waveform():
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (120, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 12.0, sps=2, seed=1)
    # fractional delay: linear interpolation by 0.37 samples
    return (iq[1:] * 0.63 + iq[:-1] * 0.37).astype(np.complex64)


STATES = dict(
    tau=np.asarray([0.0, 0.3, 2.9, -0.9], np.float32),
    rate=np.asarray([0.0, 1e-4, 2.4e-4, -2.4e-4], np.float32),
    initialized=np.asarray([0, 1, 1, 1], np.int32),
)


@pytest.mark.parametrize("n_out", [8190, 4000, 4099])
def test_ffsync_matches_jax(waveform, n_out):
    C = 4
    jsync = JFFSync(sps=2, max_block=n_out)
    sync = FeedForwardSync(sps=2, max_block=n_out, device="cpu")
    n = 2 * n_out + sync.history()
    offs = [0, 777, 2001, 5003]
    x = np.stack([cplx.from_np(waveform[o: o + n]) for o in offs])
    jst = JFFState(**{k: jnp.asarray(v) for k, v in STATES.items()})
    st = FFSyncState(**{k: torch.from_numpy(v) for k, v in STATES.items()})

    jnew, jtaps, joff, jcons = jax.vmap(
        lambda s, xx: jsync._track_impl(s, xx, n_out))(jst, jnp.asarray(x))
    new, taps, off, cons = sync._track(st, torch.from_numpy(x), n_out)
    np.testing.assert_array_equal(cons.numpy(), np.asarray(jcons))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(taps.numpy(), np.asarray(jtaps))
    np.testing.assert_allclose(new.tau.numpy(), np.asarray(jnew.tau),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.rate.numpy(), np.asarray(jnew.rate),
                               rtol=1e-5, atol=1e-9)
    # the states above slip in both directions
    slips = (np.asarray(jcons) - 2 * n_out) // 2
    assert (slips > 0).any() and (slips < 0).any()

    jnew, jsyms, jcons = jsync.step_batched(jst, jnp.asarray(x), n_out)
    new, syms, cons = sync.step_batched(st, torch.from_numpy(x), n_out)
    np.testing.assert_array_equal(cons.numpy(), np.asarray(jcons))
    np.testing.assert_allclose(syms.numpy(), np.asarray(jsyms), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(new.initialized.numpy(),
                                  np.asarray(jnew.initialized))


def test_rotate_block_matches_jax():
    rng = np.random.default_rng(4)
    iq = rng.normal(size=(3, 5000, 2)).astype(np.float32)
    ph0 = np.asarray([0.0, 1.3, 6.0], np.float32)
    inc = np.asarray([0.0, 1e-3, -2.5e-2], np.float32)
    # jitted, as the JAX receivers run it: XLA then forms the phase
    # phase0 + inc * n as one FMA, as the port does
    want, want_ph = jax.jit(jax.vmap(j_rotate_block))(
        jnp.asarray(iq), jnp.asarray(ph0), jnp.asarray(inc))
    got, got_ph = rotate_block(torch.from_numpy(iq), torch.from_numpy(ph0),
                               torch.from_numpy(inc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_ph.numpy(), np.asarray(want_ph), atol=1e-5)


def test_timing_metric_matches_jax(waveform):
    sync = FeedForwardSync(sps=2, max_block=3000, device="cpu")
    n = 6000 + sync.history()
    x = torch.from_numpy(np.stack([cplx.from_np(waveform[:n])]))
    _, syms, _ = sync.step_batched(sync.init_state(1), x, 3000)
    s = syms[0].numpy()
    hist = np.random.default_rng(5).normal(size=(90, 2)).astype(np.float32)
    for h in (np.zeros((90, 2), np.float32), hist):
        want = [np.asarray(a) for a in
                jplsync.timing_metric(jnp.asarray(s), jnp.asarray(h))]
        got = [a.numpy() for a in
               plsync.timing_metric(torch.from_numpy(s), torch.from_numpy(h))]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    assert want[0].max() > plsync.THRESHOLD_UNLOCKED
