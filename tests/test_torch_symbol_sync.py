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
import re
from pathlib import Path

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
from dvbs2rx_tpu_torch.ops import cplx, frontend, gardner_cuda
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


# ---- the kernel's launch plan and candidate rule (csrc/gardner.cu) ----

def _kernel_constants():
    src = (Path(gardner_cuda.__file__).resolve().parent.parent / "csrc"
           / "gardner.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return src, {k: int(v) for k, v in consts.items()}


def test_launch_plan_mirrors_the_kernel_constants():
    src, k = _kernel_constants()
    assert k["kThreads"] == gardner_cuda.THREADS
    assert k["kWalkers"] == gardner_cuda.WALKERS
    assert k["kHeadBytes"] == gardner_cuda.HEAD_BYTES
    assert k["kTreeWindow"] == gardner_cuda.TREE_WINDOW
    assert k["kSmemLimit"] == gardner_cuda.SMEM_LIMIT
    assert "constexpr int kCands = (kThreads - kWalkers) / 2;" in src
    assert (f"constexpr int kSlotBytes = 2 * kCands * "
            f"{gardner_cuda.SLOT_BYTES};") in src
    # the header holds two int4 hand-off words and the tile's base and flag
    assert gardner_cuda.HEAD_BYTES >= 2 * 16 + 8


@pytest.mark.parametrize("sps", [2, 4])
def test_launch_plan_fits_a_block_in_shared_memory(sps):
    """Threads per block, shared memory within Hopper's 232,448 B for the
    4,096-symbol front-end block (one tile), a forced small tile and a
    block too long for one tile."""
    G = gardner_cuda
    assert G.THREADS % 32 == 0 and G.WALKERS == 32
    assert G.WALKERS < G.THREADS <= 1024
    sync = SymbolSync(sps=sps, device="cpu")
    table, W, _ = G.window(sync)
    tf = table.size
    cands = (G.THREADS - G.WALKERS) // 2
    fixed = G.HEAD_BYTES + 2 * cands * G.SLOT_BYTES \
        + -(-tf * 4 // 16) * 16
    n = 4096 * sps + sync.history() + 64
    plan = G.launch_plan(n, W, sync.midpoint, tf)
    assert plan.tile == n and plan.smem_bytes == fixed + 8 * n
    assert plan.smem_bytes <= G.SMEM_LIMIT
    assert plan.n_cand == cands
    small = G.launch_plan(n, W, sync.midpoint, tf, max_tile=600)
    assert small.tile == 600 and small.smem_bytes == fixed + 8 * 600
    long = G.launch_plan(10 * n, W, sync.midpoint, tf)
    assert long.tile < 10 * n
    assert G.SMEM_LIMIT - 8 < long.smem_bytes <= G.SMEM_LIMIT
    with pytest.raises(ValueError, match="cannot hold"):
        G.launch_plan(n, W, sync.midpoint, tf, max_tile=W)
    for bad in (0, cands + 1):
        with pytest.raises(ValueError, match="n_cand"):
            G.launch_plan(n, W, sync.midpoint, tf, n_cand=bad)


def candidates(sps, n_subfilt, center, plan):
    """The (jump, subfilter) pairs the kernel's helpers compute for the
    next symbol when the last one's subfilter is ``center``, as its
    ``speculate`` forms them: subfilters center - (n_cand - 1) // 2 ..
    upward at jump sps, carried across the wrap of mu (below 0: jump sps -
    1 from the top subfilter down; from n_subfilt up: jump sps + 1), one per
    helper pair."""
    below = (plan.n_cand - 1) // 2
    out = []
    for i in range(plan.n_cand):
        jump, t = divmod(center - below + i, n_subfilt)
        out.append((sps + jump, t))
    return out


def candidate_slot(sps, n_subfilt, center, plan, jump, isub):
    """Which candidate the kernel's walker takes for its true (jump,
    isub), as its ``walk`` finds it; None on a miss."""
    i = (jump - sps) * n_subfilt + isub - center + (plan.n_cand - 1) // 2
    return i if 0 <= i < plan.n_cand else None


@pytest.mark.parametrize("sps", [2, 4])
def test_candidates_cover_the_neighbour_jumps_and_the_wrap(sps):
    G = gardner_cuda
    N = 128
    plan = G.launch_plan(8192, 41, 2, N * 41)
    seen = set()
    for center in (0, 1, (plan.n_cand - 1) // 2, N // 2, N - 2, N - 1):
        cands = candidates(sps, N, center, plan)
        assert len(set(cands)) == plan.n_cand
        for i, (jump, isub) in enumerate(cands):
            assert 0 <= isub < N
            assert candidate_slot(sps, N, center, plan, jump, isub) == i
        assert (sps, center) in cands
        seen |= {j for j, _ in cands}
        if center == 0:       # mu wraps from 0 down to 1: one sample less
            assert (sps - 1, N - 1) in cands
        if center == N - 1:   # mu wraps from 1 up to 0: one sample more
            assert (sps + 1, 0) in cands
        if center == N // 2:
            assert {j for j, _ in cands} == {sps}
    assert seen == {sps - 1, sps, sps + 1}
    assert candidate_slot(sps, N, N // 2, plan, sps + 2, N // 2) is None
    one = G.launch_plan(8192, 41, 2, N * 41, n_cand=1)
    assert candidates(sps, N, 5, one) == [(sps, 5)]


def _trajectory(sync, iq, n_syms):
    """(jump, subfilter) of every strobe of the plain loop, one symbol per
    call, with the subfilter each symbol started from."""
    st = sync.init_state(1)
    x = torch.from_numpy(cplx.from_np(iq)[None])
    N = sync.n_subfilt
    sub = lambda mu: min(max(int(np.floor(np.float32(N) * mu)), 0), N - 1)
    out = []
    for _ in range(n_syms):
        center = sub(float(st.mu[0]))
        st, _ = gardner_cuda.symbol_sync_plain(sync, st, x, 1)
        out.append((center, int(st.jump[0]), sub(float(st.mu[0]))))
    return out


@pytest.mark.parametrize("sps,sigma", [(2, 0.05), (2, 0.5), (4, 0.5)])
def test_candidate_rule_picks_the_plain_loops_strobe(sps, sigma):
    """On the plain loop's trajectory, wherever the rule calls a symbol a
    hit, the candidate it picks is the loop's own (jump, subfilter); the
    rule hits almost always, and a one-candidate plan only where the
    strobe is the expected one."""
    G = gardner_cuda
    kw = dict(loop_bw=0.005, damping=0.707) if sps == 4 else {}
    sync = SymbolSync(sps=sps, device="cpu", **kw)
    _, iq = _tx_waveform(260, sps, 0.2, seed=21, frac_delay=0.3)
    traj = _trajectory(sync, noisy(iq, 21, sigma), 240)
    N = sync.n_subfilt
    _, W, _ = G.window(sync)
    for n_cand in (None, 1):
        plan = G.launch_plan(4096, W, sync.midpoint, N * W, n_cand=n_cand)
        hits = 0
        for center, jump, isub in traj:
            i = candidate_slot(sps, N, center, plan, jump, isub)
            if i is not None:
                assert candidates(sps, N, center, plan)[i] == (jump, isub)
                hits += 1
            elif n_cand == 1:
                assert (jump, isub) != (sps, center)
        if n_cand is None:
            assert hits >= 0.97 * len(traj)
        else:
            assert hits < len(traj)
