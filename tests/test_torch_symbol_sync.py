"""The port's Gardner ``SymbolSync`` (``ops/frontend.py``, plain loop of
``ops/gardner_cuda.py`` on the CPU) against the JAX ``SymbolSync``.

Stimuli as ``tests/test_symbol_sync.py``'s: 1,000-2,000 RRC-shaped QPSK
symbols with a fractional delay (raised-cosine shaped for the linear and
Farrow interpolators, which assume an upstream matched filter), plus
numpy-seeded noise. Integers (``jump``, ``n``, and what a caller consumes)
must be equal. Symbols and the float state must lie within atol 1e-5: the
port replays XLA's CPU float32 order (FMA chains, the tree reduction of
long dot products), so it matches bit for bit here; the tolerance leaves
room for the plain version's float64 FMA, which rounds twice in about
2^-29 of cases.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvbs2rx_tpu.ops import frontend as jfrontend
from dvbs2rx_tpu.ops.frontend import SymbolSync as JSymbolSync

from dvbs2rx_tpu_torch.convert import (
    symbol_sync_state_from_numpy,
    symbol_sync_state_to_numpy,
)
from dvbs2rx_tpu_torch.ops import cplx, frontend
from dvbs2rx_tpu_torch.ops.frontend import SymbolSync
from dvbs2rx_tpu_torch.ops.resample import StreamResampler

from tests.test_symbol_sync import _rc_waveform, _tx_waveform

torch.set_num_threads(2)

FIELDS = ("cnt", "mu", "vi", "jump", "last_xi", "n")
INTS = ("jump", "n")
FLOATS = ("cnt", "mu", "vi", "last_xi")


def noisy(iq, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    return (iq + sigma * (rng.normal(size=iq.size)
                          + 1j * rng.normal(size=iq.size))).astype(np.complex64)


def wave(method, n_syms, sps, seed, frac_delay):
    make = _tx_waveform if method == "polyphase" else _rc_waveform
    return noisy(make(n_syms, sps, 0.2, seed=seed, frac_delay=frac_delay)[1],
                 seed)


def jax_state_np(st):
    return {k: np.asarray(getattr(st, k)) for k in FIELDS}


def assert_matches_jax(state, syms, jstate, jsyms, c=0):
    """Channel ``c`` of the port's (state, symbols) against the JAX
    single-channel result."""
    ours = symbol_sync_state_to_numpy(state)
    for k in INTS:
        assert ours[k][c] == np.asarray(getattr(jstate, k)), k
    for k in FLOATS:
        np.testing.assert_allclose(ours[k][c], np.asarray(getattr(jstate, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(syms[c].numpy(), np.asarray(jsyms), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("rolloff", [0.2, 0.35, 0.05])
def test_loop_constants_match_jax(rolloff):
    assert frontend.gted_gain(rolloff) == jfrontend.gted_gain(rolloff)
    for sps, bw, damping in ((2, 0.01, 1.0), (4, 0.005, 0.707)):
        assert frontend.pi_constants(sps, bw, damping, rolloff) == \
            jfrontend.pi_constants(sps, bw, damping, rolloff)


CASES = {
    "polyphase": dict(method="polyphase", sps=2, frac_delay=0.37),
    "linear": dict(method="linear", sps=2, frac_delay=0.43),
    "quadratic": dict(method="quadratic", sps=2, frac_delay=0.61),
    "cubic": dict(method="cubic", sps=2, frac_delay=0.19),
    # the reference QA's second loop; 41 taps take XLA's tree reduction
    "polyphase_sps4": dict(method="polyphase", sps=4, frac_delay=0.77,
                           loop_bw=0.005, damping=0.707),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_interpolator_matches_jax(case):
    kw = dict(CASES[case])
    method, sps, frac = kw.pop("method"), kw.pop("sps"), kw.pop("frac_delay")
    iq = wave(method, 1500, sps, seed=3, frac_delay=frac)
    n_out = 1400
    jsync = JSymbolSync(sps=sps, interp_method=method, **kw)
    jst, jsyms = jsync.step(jsync.init_state(), cplx.from_np(iq), n_out)
    sync = SymbolSync(sps=sps, interp_method=method, device="cpu", **kw)
    assert sync.history() == jsync.history()
    st, syms = sync.step(sync.init_state(1),
                         torch.from_numpy(cplx.from_np(iq)[None]), n_out)
    assert syms.shape == (1, n_out, 2)
    assert_matches_jax(st, syms, jst, jsyms)
    # the loop converged: the tail sits on the QPSK constellation
    tail = cplx.to_np(syms[0, -300:])
    assert np.std(np.abs(tail)) < 0.25 * np.mean(np.abs(tail))


def test_init_state_matches_jax():
    for sps, method in ((2, "polyphase"), (4, "polyphase"), (2, "cubic"),
                        (2, "linear")):
        jsync = JSymbolSync(sps=sps, interp_method=method)
        sync = SymbolSync(sps=sps, interp_method=method, device="cpu")
        ours = symbol_sync_state_to_numpy(sync.init_state(3))
        for k, v in jax_state_np(jsync.init_state()).items():
            assert ours[k].dtype == v.dtype, k
            for c in range(3):
                np.testing.assert_array_equal(ours[k][c], v, err_msg=k)
    with pytest.raises(ValueError, match="even integer"):
        SymbolSync(sps=3, device="cpu")
    with pytest.raises(ValueError, match="interpolation"):
        SymbolSync(interp_method="sinc", device="cpu")


def test_streaming_blocks_equal_one_shot():
    """Two blocks with the consumed samples dropped and ``n`` rebased equal
    one call, and the JAX loop streamed the same way."""
    iq = wave("polyphase", 2000, 2, seed=2, frac_delay=0.4)
    x = torch.from_numpy(cplx.from_np(iq)[None])
    sync = SymbolSync(device="cpu")
    _, once = sync.step(sync.init_state(1), x, 1800)
    st1, out1 = sync.step(sync.init_state(1), x, 900)
    consumed = int(st1.n[0]) + 1 - sync.history()
    st1.n = st1.n - consumed
    st2, out2 = sync.step(st1, x[:, consumed:], 900)
    torch.testing.assert_close(torch.cat([out1, out2], 1), once, rtol=0,
                               atol=1e-6)
    jsync = JSymbolSync()
    j1, jo1 = jsync.step(jsync.init_state(), cplx.from_np(iq), 900)
    assert int(j1.n) + 1 - jsync.history() == consumed
    j1 = dataclasses.replace(j1, n=j1.n - consumed)
    j2, jo2 = jsync.step(j1, cplx.from_np(iq[consumed:]), 900)
    assert_matches_jax(st2, out2, j2, jo2)


def test_channels_equal_single_calls():
    """C = 3 channels with distinct waveforms and states in one call equal
    three single-channel calls, and JAX from the same states."""
    sync = SymbolSync(device="cpu")
    jsync = JSymbolSync()
    waves = [wave("polyphase", 1200, 2, seed=7 + c, frac_delay=0.2 + 0.3 * c)
             for c in range(3)]
    n = min(w.size for w in waves)
    x = torch.from_numpy(np.stack([cplx.from_np(w[:n]) for w in waves]))
    starts = [dict(jax_state_np(jsync.init_state()), mu=np.float32(m),
                   vi=np.float32(v), cnt=np.float32(cn))
              for m, v, cn in ((0.0, 0.0, 0.5), (0.4, 1e-3, 0.7),
                               (0.9, -2e-3, 0.2))]
    st0 = symbol_sync_state_from_numpy(
        {k: np.stack([s[k] for s in starts]) for k in starts[0]}, "cpu")
    st, syms = sync.step(st0, x, 1000)
    ours = symbol_sync_state_to_numpy(st)
    for c in range(3):
        one_st, one = sync.step(symbol_sync_state_from_numpy(starts[c], "cpu"),
                                x[c: c + 1], 1000)
        torch.testing.assert_close(syms[c: c + 1], one, rtol=0, atol=0)
        for k, v in symbol_sync_state_to_numpy(one_st).items():
            np.testing.assert_array_equal(ours[k][c], v[0], err_msg=k)
        jst = jfrontend.SymbolSyncState(
            **{k: jnp.asarray(v) for k, v in starts[c].items()})
        jst, jsyms = jsync.step(jst, cplx.from_np(waves[c][:n]), 1000)
        assert_matches_jax(st, syms, jst, jsyms, c)


def test_drift_reaches_the_window_clamp():
    """A 0.4% sample-clock offset and more symbols than the block holds:
    the strobes run past the block's end, where the window start clamps to
    n - L (as ``lax.dynamic_slice`` clamps it); integers still equal."""
    _, iq = _tx_waveform(1200, 2, 0.2, seed=5)
    iq = noisy(StreamResampler(1.004)(iq), 5)
    n_out = iq.size // 2 + 30
    jsync = JSymbolSync()
    jst, jsyms = jsync.step(jsync.init_state(), cplx.from_np(iq), n_out)
    sync = SymbolSync(device="cpu")
    st, syms = sync.step(sync.init_state(1),
                         torch.from_numpy(cplx.from_np(iq)[None]), n_out)
    assert int(st.n[0]) >= iq.size          # the last windows were clamped
    assert_matches_jax(st, syms, jst, jsyms)


def test_state_carries_over_from_jax():
    """The port continues a JAX loop from its state (``convert``), and the
    state converts back unchanged."""
    iq = wave("cubic", 1500, 2, seed=11, frac_delay=0.3)
    jsync = JSymbolSync(interp_method="cubic")
    j1, _ = jsync.step(jsync.init_state(), cplx.from_np(iq), 600)
    st = symbol_sync_state_from_numpy(jax_state_np(j1), "cpu")
    back = symbol_sync_state_to_numpy(st)
    for k, v in jax_state_np(j1).items():
        assert back[k].dtype == v.dtype and back[k].shape[0] == 1
        np.testing.assert_array_equal(back[k][0], v, err_msg=k)
    sync = SymbolSync(interp_method="cubic", device="cpu")
    st2, syms = sync.step(st, torch.from_numpy(cplx.from_np(iq)[None]), 600)
    j2, jsyms = jsync.step(j1, cplx.from_np(iq), 600)
    assert_matches_jax(st2, syms, j2, jsyms)
