"""The shared front end's kernels' plain versions against the JAX package,
and the wrappers' index math.

- The stream step's front end (``StreamFrontEnd._frontend``: AGC, rotator,
  the append to the right-aligned sample buffer, the O&M tracker and the
  matched filter reading the buffer in place) against the JAX stream
  step's ``frontend`` closure (``dvbs2rx_tpu/rx/stream.py:179-221``),
  jitted, AGC on and off, at short frames on 3 channels whose fills
  overflow, underflow and sit in between: the buffer within 2e-6 (unit
  RMS samples: sin and cos an ulp apart, the gain an ulp apart), fills and
  flags equal, the gain within rtol 1e-6, the phase within 1e-6 rad, tau
  and the rate within rtol 1e-5 (the existing tracker tolerance), the
  symbols within 1e-4.
- ``frontend_plain`` without a buffer (AGC off, update and given gain) at
  n = 133,128 samples with rotator increments that take the phase past
  1e5 rad, against the JAX AGC expression and ``rotate_block``, jitted:
  within 2e-6 (XLA forms the phase as one FMA, as the port does).
- ``FeedForwardSync._track`` reading the block in place from a longer
  buffer (starts clamped at both ends), multi- and single-window, against
  the JAX ``_track_impl`` on ``dynamic_slice`` windows: consumed, offsets
  and taps exact, tau and rate within rtol 1e-5.
- The in-place matched filter, ``mf_decimate`` and ``step_batched`` equal
  the gather-then-filter form exactly.
- The wrappers' constants against the CUDA sources, the tracker's plan at
  every path's block (its clusters: at most 8 blocks a channel, every
  piece taken once, the partials added window by window, piece by piece,
  warp by warp), the AGC's chunked partial sums in the kernel's order
  (a numpy mirror: within 1e-15 of the float64 mean), the edge margin.
- A numpy mirror of the tracker kernel's window sums (8 samples a thread
  in double, the warp's shuffle tree, the partials in the plan's order)
  and of lane 0's float32 chain gives the plain tracker's tau and drift
  within the bench's TRACK_TOL samples.
- The stamp tool's text edits fit this checkout's tracker source.
"""

import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvbs2rx_tpu.ops.ffsync import FeedForwardSync as JFFSync
from dvbs2rx_tpu.ops.ffsync import FFSyncState as JFFState
from dvbs2rx_tpu.ops.frontend import rotate_block as j_rotate_block
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.stream import StreamReceiver as JStreamReceiver
from dvbs2rx_tpu.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch.ops import cplx, ffsync_cuda, fir_cuda, frontend_cuda
from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync, FFSyncState
from dvbs2rx_tpu_torch.ops.frontend import rotate_block
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import StreamReceiver, prime_agc

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "dvbs2rx_tpu_torch" / "csrc"
TOOLS = CSRC.parent.parent / "tools"


@pytest.fixture(scope="module")
def waveform():
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(3)
    pkts = rng.integers(0, 256, (240, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 10.0, sps=2, seed=2)
    return (iq[1:] * 0.7 + iq[:-1] * 0.3).astype(np.complex64)


def _jax_frontend(jsr):
    """The JAX stream step's ``frontend`` closure, jitted."""
    step = jsr.raw_step
    cells = dict(zip(step.__code__.co_freevars, step.__closure__))
    return jax.jit(cells["frontend"].cell_contents)


@pytest.mark.parametrize("agc", [True, False])
def test_stream_frontend_matches_jax(waveform, agc):
    C = 3
    kw = dict(modcod="qpsk1/2", frame_size="short", agc=agc,
              agc_rate=1e-4)
    jsr = JStreamReceiver(JRxConfig(**kw), C)
    sr = StreamReceiver(RxConfig(**kw), C, device="cpu")
    N, n_in, n_fe = sr.N_BUF, sr.n_in, sr._n_fe
    assert (N, n_in, n_fe) == (jsr.N_BUF, jsr.n_in, jsr._n_fe)
    x = cplx.from_np(waveform)
    offs = (0, 3001, 7777)
    st = sr.init_state_np()
    for c, o in enumerate(offs):
        st["sbuf"][c] = x[o: o + N]
    iq = np.stack([x[o + N: o + N + n_in] for o in offs]) * np.float32(1.7)
    # channel 0 overflows; channel 2's fill leaves the next read short
    st["sfill"][:] = (N - n_in + 5, n_fe - n_in + 40, n_fe - n_in - 900)
    st["agc_gain"][:] = (0.8, 1.0, 1.3)
    st["rot_phase"][:] = (0.0, 2.5, 6.2)
    st["rot_inc"][:] = (0.0, 3e-3, -0.021)
    st["ff_tau"][:] = (0.0, 0.4, 1.7)
    st["ff_rate"][:] = (0.0, 1e-4, -5e-5)
    st["ff_init"][:] = (0, 1, 1)
    keys = ("sbuf", "sfill", "agc_gain", "rot_phase", "rot_inc", "ff_tau",
            "ff_rate", "ff_init")
    jst, jsyms, jover, junder = _jax_frontend(jsr)(
        {k: jnp.asarray(st[k]) for k in keys}, jnp.asarray(iq))
    tst = {k: torch.from_numpy(st[k]) for k in keys}
    got, syms, over, under = sr._frontend(tst, torch.from_numpy(iq))
    np.testing.assert_allclose(got["sbuf"].numpy(), np.asarray(jst["sbuf"]),
                               rtol=0, atol=2e-6)
    for k in ("sfill", "ff_init"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jst[k]))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    np.testing.assert_array_equal(under.numpy(), np.asarray(junder))
    assert over.numpy().tolist() == [True, False, False]
    assert under.numpy()[2]
    np.testing.assert_allclose(got["agc_gain"].numpy(),
                               np.asarray(jst["agc_gain"]), rtol=1e-6)
    np.testing.assert_allclose(got["rot_phase"].numpy(),
                               np.asarray(jst["rot_phase"]), atol=1e-6)
    np.testing.assert_allclose(got["ff_tau"].numpy(),
                               np.asarray(jst["ff_tau"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["ff_rate"].numpy(),
                               np.asarray(jst["ff_rate"]), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(syms.numpy(), np.asarray(jsyms), rtol=0,
                               atol=1e-4)


def _jax_block(agc, alpha, agc_ref):
    """The JAX front end's AGC lines and ``rotate_block``, without the
    buffer, jitted: agc "off", "update" or "given"."""
    def fn(iq, gain, ph0, inc):
        if agc == "update":
            mag = jnp.mean(jnp.sqrt(iq[..., 0] ** 2 + iq[..., 1] ** 2),
                           axis=-1)
            target = agc_ref / jnp.maximum(mag, 1e-12)
            gain = (1.0 - alpha) * gain + alpha * target
        if agc != "off":
            iq = iq * gain[:, None, None]
        rot, phase = jax.vmap(j_rotate_block)(iq, ph0, inc)
        return rot, phase, gain
    return jax.jit(fn)


@pytest.mark.parametrize("agc", frontend_cuda.AGC_MODES)
def test_rotator_past_1e5_rad_matches_jax(agc):
    n = 133_128
    rng = np.random.default_rng(7)
    iq = rng.normal(size=(2, n, 2)).astype(np.float32)
    gain = np.asarray([0.9, 1.2], np.float32)
    ph0 = np.asarray([1.234, 5.9], np.float32)
    inc = np.asarray([-0.7321, 0.95], np.float32)     # |ph| up to 1.3e5
    assert float(np.abs(inc).max()) * n > 1e5
    want, want_ph, want_g = _jax_block(agc, 0.25, 1.1)(
        iq, gain, ph0, inc)
    got = frontend_cuda.frontend(*(torch.from_numpy(a) for a in
                                   (iq, gain, ph0, inc)), agc, 0.25, 1.1)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["phase"].numpy(), np.asarray(want_ph),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(want_g),
                               rtol=1e-6)
    # rotate_block on a CPU tensor is the same plain rotation
    if agc == "off":
        rot, ph = rotate_block(torch.from_numpy(iq), torch.from_numpy(ph0),
                               torch.from_numpy(inc))
        assert torch.equal(rot, got["out"]) and torch.equal(ph, got["phase"])


def test_prime_agc_is_the_jax_priming_gain():
    rng = np.random.default_rng(8)
    iq = torch.from_numpy(rng.normal(size=(3, 5000, 2)).astype(np.float32))
    for agc in (True, False):
        cfg = RxConfig(modcod="qpsk1/2", frame_size="short", agc=agc,
                       agc_ref=0.8)
        out, gain = prime_agc(iq, cfg)
        if agc:
            mag = torch.sqrt(iq[..., 0] ** 2 + iq[..., 1] ** 2).mean(-1)
            want = 0.8 / mag.clamp(min=1e-12)
            assert torch.equal(gain, want)
            assert torch.equal(out, iq * want[:, None, None])
        else:
            assert torch.equal(gain, torch.ones(3))
            assert torch.equal(out, iq)


@pytest.mark.parametrize("n_out", [9000, 4096])
def test_track_in_place_matches_jax(waveform, n_out):
    C = 4
    jsync = JFFSync(sps=2, max_block=n_out)
    sync = FeedForwardSync(sps=2, max_block=n_out, device="cpu")
    length = 2 * n_out + sync.history() + 64
    N = length + 3000
    x = cplx.from_np(waveform)
    buf = np.stack([x[o: o + N] for o in (0, 501, 1703, 2999)])
    start = np.asarray([-40, 1234, N - length + 77, N], np.int64)
    clamped = np.clip(start, 0, N - length)
    blocks = np.stack([buf[c, s: s + length] for c, s in enumerate(clamped)])
    states = dict(tau=np.asarray([0.0, 0.3, 1.6, -0.7], np.float32),
                  rate=np.asarray([0.0, 1e-4, -2e-4, 2.2e-4], np.float32),
                  initialized=np.asarray([0, 1, 1, 1], np.int32))
    jst = JFFState(**{k: jnp.asarray(v) for k, v in states.items()})
    st = FFSyncState(**{k: torch.from_numpy(v) for k, v in states.items()})
    jnew, jtaps, joff, jcons = jax.jit(jax.vmap(
        lambda s, xx: jsync._track_impl(s, xx, n_out)))(
            jst, jnp.asarray(blocks))
    new, taps, off, cons = sync._track(st, torch.from_numpy(buf), n_out,
                                       torch.from_numpy(start), length)
    np.testing.assert_array_equal(cons.numpy(), np.asarray(jcons))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(taps.numpy(), np.asarray(jtaps))
    np.testing.assert_allclose(new.tau.numpy(), np.asarray(jnew.tau),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.rate.numpy(), np.asarray(jnew.rate),
                               rtol=1e-5, atol=1e-9)
    assert (length >= 16384) == (n_out == 9000)     # both branches


def test_in_place_mf_and_step_equal_the_gathered_block(waveform):
    sync = FeedForwardSync(sps=2, max_block=4099, device="cpu")
    x = torch.from_numpy(cplx.from_np(waveform))
    for n_out in (4096, 4099):        # 16 segments; one segment (prime)
        length = 2 * n_out + sync.history()
        N = length + 500
        buf = torch.stack([x[o: o + N] for o in (0, 97, 1501)])
        start = torch.tensor([-3, 250, N], dtype=torch.int32)
        block = cplx.window_rows(buf, start, length)
        st = sync.init_state(3)
        got = sync.step_batched(st, buf, n_out, start=start, length=length)
        want = sync.step_batched(st, block, n_out)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
        assert torch.equal(got[0].tau, want[0].tau)
    rng = np.random.default_rng(9)
    taps = torch.from_numpy(rng.normal(size=(3, 4, 21)).astype(np.float32))
    base = torch.from_numpy(rng.integers(-3, 12, (3, 4)).astype(np.int32))
    length = (4 * 100 - 1) * 2 + 21 + 9
    buf = torch.from_numpy(rng.normal(size=(3, length + 40, 2)).astype(
        np.float32))
    start = torch.tensor([-1, 17, 10_000], dtype=torch.int64)
    got = fir_cuda.mf_segmented(buf, taps, base, 2, 100, 9, start, length)
    want = fir_cuda.mf_segmented_plain(
        cplx.window_rows(buf, start, length), taps, base, 2, 100, 9)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="history too short"):
        fir_cuda.mf_segmented(buf, taps, base, 2, 100, 9, start, length - 1)
    with pytest.raises(ValueError, match="together"):
        fir_cuda.mf_segmented(buf, taps, base, 2, 100, 9, start)


def _source_int(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wrapper_constants_match_the_sources():
    fe = (CSRC / "frontend.cu").read_text()
    ff = (CSRC / "ffsync.cu").read_text()
    assert _source_int("kAgcChunk", fe) == frontend_cuda.CHUNK
    assert (_source_int("kRotThreads", fe) * _source_int("kRotPer", fe)
            == frontend_cuda.TILE_ROWS)
    assert _source_int("kGroup", ff) * _source_int("kPer", ff) \
        == ffsync_cuda.PIECE
    assert _source_int("kMaxPieces", ff) == ffsync_cuda.MAX_PIECES
    assert _source_int("kMaxWindows", ff) == ffsync_cuda.MAX_WINDOWS
    assert _source_int("kMaxSeg", ff) == ffsync_cuda.MAX_SEGMENTS
    # the cluster plan's constants and a piece's staging bytes
    assert _source_int("kGroup", ff) == ffsync_cuda.GROUP
    assert _source_int("kMaxPer", ff) == ffsync_cuda.MAX_PER
    assert _source_int("kMaxCluster", ff) == ffsync_cuda.MAX_CLUSTER
    assert "constexpr int kMaxThreads = kGroup * kMaxPer;" in ff
    n = _source_int("kGroup", ff) * _source_int("kPer", ff)
    halo = _source_int("kTaps", ff) - 1
    assert "return i + (i >> 3);" in ff
    slots = (n + halo) + (n + halo) // 8 + 1      # padded(kPiece + kHalo) + 1
    assert (slots * 8 + 15) // 16 * 16 == ffsync_cuda.PIECE_BYTES
    assert ("const int per = (n_pieces + kMaxCluster - 1) / kMaxCluster;"
            in ff)
    # the O&M odd branch: 12 taps, 6 before and 5 after a sample
    assert (_source_int("kTaps", ff), _source_int("kLead", ff)) == (12, 6)
    assert np.float32(frontend_cuda.TWO_PI) == np.float32(2 * math.pi)


@pytest.mark.parametrize("kind", ["ccm", "vcm", "host", "bench"])
def test_tracker_plan_takes_every_paths_block(kind):
    """The kernel's fixed sizes take the block of every path: the stream
    steps' n_fe samples at normal frames (multi-window), the host
    receivers' 4,096-symbol blocks (single window) and the bench's 32,768
    symbols."""
    if kind in ("ccm", "vcm"):
        from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
        from dvbs2rx_tpu_torch.spec.pls import make_pls

        if kind == "ccm":
            sr = StreamReceiver(RxConfig(modcod="qpsk1/2",
                                         frame_size="normal"), 1,
                                device="cpu")
        else:
            sr = VCMStreamReceiver(RxConfig(
                modcod="qpsk1/2", frame_size="normal", acm_vcm=True,
                pls_expected=(make_pls(4, False, True),
                              make_pls(12, False, True))), 1, device="cpu")
        sync, n_out, n = sr.sync, sr.n_out, sr._n_fe
    else:
        n_out = 4096 if kind == "host" else 32_768
        sync = FeedForwardSync(sps=2, device="cpu")
        n = 2 * n_out + sync.history() + 64
    multi, W, wlen, offs = ffsync_cuda.windows(n, sync.est_window)
    assert multi == (kind != "host")
    ffsync_cuda.check_plan(n, sync.est_window, sync.segments(n_out),
                           sync.bank.numel())
    assert offs.dtype == np.int32 and (offs % 2 == 0).all()
    assert int(offs.max()) + wlen <= n
    with pytest.raises(ValueError, match="33 segments"):
        ffsync_cuda.check_plan(n, sync.est_window, 33)
    with pytest.raises(ValueError, match="shared memory"):
        ffsync_cuda.check_plan(n, sync.est_window, 16, 4096 * 21)
    # the cluster plan: at most 8 blocks a channel, at most MAX_PER pieces
    # a block, every piece taken once, no idle block; the partials added
    # window by window, piece by piece, warp by warp
    ppw = -(-wlen // ffsync_cuda.PIECE)
    pieces = W * ppw
    G, per, threads = ffsync_cuda.plan(pieces)
    assert 1 <= G <= ffsync_cuda.MAX_CLUSTER
    assert 1 <= per <= ffsync_cuda.MAX_PER
    assert threads == per * ffsync_cuda.GROUP
    taken = [r * per + g for r in range(G) for g in range(per)
             if r * per + g < pieces]
    assert taken == list(range(pieces))
    assert (G - 1) * per < pieces
    order = ffsync_cuda.combine_order(W, ppw, per)
    assert [(w, p, u) for w, p, _, _, u in order] == [
        (w, p, u) for w in range(W) for p in range(w * ppw, (w + 1) * ppw)
        for u in range(ffsync_cuda.WARPS)]
    assert all((r, s) == divmod(p, per) for _, p, r, s, _ in order)
    # 16 windows (the streams, the bench): 8 blocks of 2 pieces; a host
    # block's window of 9 pieces (8,295 samples): 5 blocks of 2
    assert (G, per, threads) == ((5, 2, 256) if kind == "host"
                                 else (8, 2, 256))
    for n_pieces in range(1, ffsync_cuda.MAX_PIECES + 1):
        G, per, _ = ffsync_cuda.plan(n_pieces)
        assert G <= ffsync_cuda.MAX_CLUSTER
        assert (G - 1) * per < n_pieces <= G * per


def _tree(v):
    """``__shfl_xor_sync``'s butterfly over a warp's 32 lanes, lane 0's
    sum (the kernels' warp_sum)."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def _fma32(a, b, c):
    """float32 fmaf: the product exact in float64, one rounding (the sum's
    own float64 rounding aside, far below TRACK_TOL)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _mod32(x, m):
    """mod_rn in float32 (ops/cplx.mod's arithmetic)."""
    r = np.fmod(np.float32(x), np.float32(m))
    return np.float32(r + m) if r != 0 and (r < 0) != (m < 0) else r


def _kernel_tau(sync, tau_in, rate_in, init, block, n_out):
    """A numpy mirror of the tracker kernel on one channel's block (n, 2)
    float32: each piece's 128 threads sum 8 consecutive samples' O&M terms
    in double, each warp's shuffle tree, the partials added in the plan's
    ``combine_order``, each window's atan2, then lane 0's float32 chain:
    (tau', rate')."""
    f32 = np.float32
    n = block.shape[0]
    multi, W, wlen, offs = ffsync_cuda.windows(n, sync.est_window)
    ppw = -(-wlen // ffsync_cuda.PIECE)
    per = ffsync_cuda.plan(W * ppw).per
    hb = sync._hb_even_rev.numpy()
    cc = f32(sync._center * sync._center)
    parts = {}
    for p in range(W * ppw):
        w, k0 = divmod(p, ppw)
        k0 *= ffsync_cuda.PIECE
        win = block[int(offs[w]): int(offs[w]) + wlen]
        ks = np.arange(k0 - 6, k0 + ffsync_cuda.PIECE + 5)
        ok = (ks >= 0) & (ks < wlen)
        stage = np.zeros((ks.size, 2), np.float32)
        stage[ok] = win[ks[ok]]
        k = np.arange(k0, k0 + ffsync_cuda.PIECE)
        o = np.zeros((k.size, 2), np.float32)
        for j in range(12):
            o = _fma32(stage[k - k0 + j], hb[j], o)
        xs = stage[k - k0 + 6]
        se = (cc * (xs[:, 0] * xs[:, 0] + xs[:, 1] * xs[:, 1])).astype(f32)
        so = (o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1]).astype(f32)
        sign = np.where(k % 2 == 1, -1.0, 1.0)
        live = k < wlen
        t_re = np.where(live, sign * se, 0.0).reshape(128, 8)
        t_im = np.where(live & (k != 0), sign * so, 0.0).reshape(128, 8)
        re, im = np.zeros(128), np.zeros(128)
        for r in range(8):                   # each thread's sum in order
            re, im = re + t_re[:, r], im + t_im[:, r]
        for u in range(ffsync_cuda.WARPS):
            parts[(p // per, p % per, u)] = (_tree(re[32 * u: 32 * u + 32]),
                                             _tree(im[32 * u: 32 * u + 32]))
    sums = np.zeros((W, 2))
    for w, _, r, s, u in ffsync_cuda.combine_order(W, ppw, per):
        sums[w] += parts[(r, s, u)]
    sps, half = f32(sync.sps), f32(sync.sps / 2)
    tw = [f32(f32(-np.arctan2(f32(i), f32(q))) / f32(ffsync_cuda.TWO_PI)
              * sps) for q, i in sums]
    if multi:
        from dvbs2rx_tpu_torch.ops.ffsync import _window_centres

        wc = _window_centres(n, sync.sps)
        t_un = [f32(0)]
        for i in range(1, W):
            d = f32(_mod32(f32(f32(tw[i] - tw[i - 1]) + half), sps) - half)
            t_un.append(f32(t_un[-1] + d))
        sw = st = f32(0)
        for i in range(W):
            sw, st = f32(sw + wc[i]), f32(st + t_un[i])
        wbar, tbar = f32(sw / f32(W)), f32(st / f32(W))
        num = den = f32(0)
        for i in range(W):
            dw = f32(wc[i] - wbar)
            num = f32(num + f32(dw * f32(t_un[i] - tbar)))
            den = f32(den + f32(dw * dw))
        slope = f32(num / den)
        tau_meas = _mod32(f32(f32(tw[0] + tbar) - f32(slope * wbar)), sps)
        mr = f32(2.5e-4)
        rate_meas = f32(min(max(slope, -mr), mr))
        innov = f32(_mod32(f32(f32(tau_meas - tau_in) + half), sps) - half)
        g = f32(sync.rate_gain)
        rate = f32(min(max(f32(f32(rate_in + f32(g * f32(rate_meas - rate_in)))
                               + f32(f32(g * innov) / f32(n_out))), -mr), mr)) \
            if init else rate_meas
        tau0 = f32(tau_in + f32(f32(sync.smooth) * innov)) if init \
            else tau_meas
    else:
        tau_meas = _mod32(tw[0], sps)
        c_sym = f32(min(sync.est_window, n) / (2.0 * sync.sps))
        pred = f32(tau_in + f32(rate_in * c_sym))
        innov = f32(_mod32(f32(f32(tau_meas - pred) + half), sps) - half)
        tau0 = f32(tau_in + f32(f32(sync.smooth) * innov)) if init \
            else tau_meas
        rate = f32(min(max(f32(rate_in + f32(f32(f32(sync.rate_gain) * innov)
                                               / f32(n_out))), -2.5e-4),
                       2.5e-4)) if init else f32(0)
    pos_end = f32(tau0 + f32(rate * f32(n_out)))
    slip = 0 if -half <= pos_end < 3 * half else int(np.floor(
        f32(f32(pos_end + half) / sps)))
    return f32(pos_end - f32(f32(slip) * sps)), rate


@pytest.mark.parametrize("n_out", [9000, 4096])
def test_kernel_sums_in_the_plans_order_give_the_plain_tau(waveform, n_out):
    """The tracker kernel's arithmetic, mirrored in numpy in the plan's
    order (``_kernel_tau``), against ``_track_plain`` on the seeded
    waveform: tau and the drift over the block within TRACK_TOL samples,
    multi-window (16 windows of one piece each) and single-window (9
    pieces over 5 blocks), on a fresh and an initialised state."""
    from dvbs2rx_tpu_torch.bench import TRACK_TOL

    sync = FeedForwardSync(sps=2, max_block=n_out, device="cpu")
    n = 2 * n_out + sync.history() + 64
    x = cplx.from_np(waveform)
    blocks = np.stack([x[o: o + n] for o in (0, 1201)])
    st = FFSyncState(tau=torch.tensor([0.0, 1.3]),
                     rate=torch.tensor([0.0, -1.2e-4]),
                     initialized=torch.tensor([0, 1], dtype=torch.int32))
    want, _, _, _ = sync._track_plain(st, torch.from_numpy(blocks), n_out)
    for c in range(2):
        tau, rate = _kernel_tau(sync, np.float32(st.tau[c]),
                                np.float32(st.rate[c]),
                                bool(st.initialized[c]), blocks[c], n_out)
        dtau = (tau - float(want.tau[c]) + 1) % 2 - 1
        assert abs(dtau) <= TRACK_TOL
        assert abs(float(rate) - float(want.rate[c])) * n_out <= TRACK_TOL


def test_ffsync_variant_edits_fit_the_source():
    """``tools/torch_ffsync_variants.py``'s edits of this checkout's
    tracker source each fit it exactly once."""
    sys.path.insert(0, str(TOOLS))
    try:
        import torch_ffsync_variants as tool
        from torch_variant_common import apply_edits
    finally:
        sys.path.remove(str(TOOLS))
    src = (CSRC / "ffsync.cu").read_text()
    for name, (side, edits) in tool.EDITS.items():
        if side == "new":
            assert apply_edits(src, edits).count("STAMP") >= \
                2 * ("stamps" in name), name


def test_agc_partial_sums_in_the_kernels_order():
    """A numpy mirror of the AGC kernels' reduction: each chunk of CHUNK
    samples summed by 256 threads (stride 256) and a shuffle tree in
    double, then per channel lane k of warp 0 over chunks k, k + 32, ...
    and a tree: every sample once, within 1e-15 of the float64 mean."""
    rng = np.random.default_rng(10)
    n = 133_128
    x = rng.normal(size=(n, 2)).astype(np.float32)
    mag = np.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]).astype(np.float64)

    def tree(v):                       # __shfl_xor_sync, lane 0's view
        v = v.copy()
        for o in (16, 8, 4, 2, 1):
            v = v + v[np.arange(32) ^ o]
        return v[0]

    k = frontend_cuda.n_chunks(n)
    parts = []
    for c in range(k):
        seg = mag[c * frontend_cuda.CHUNK: (c + 1) * frontend_cuda.CHUNK]
        th = np.zeros(256)
        for i, v in enumerate(seg):
            th[i % 256] += v
        parts.append(sum(tree(th[w * 32:(w + 1) * 32]) for w in range(8)))
    lanes = np.zeros(32)
    for c, p in enumerate(parts):
        lanes[c % 32] += p
    mean = tree(lanes) / n
    assert k == -(-n // frontend_cuda.CHUNK) and k * frontend_cuda.CHUNK >= n
    assert abs(mean - mag.mean()) <= 1e-15 * mag.mean()
    torch_mean = torch.from_numpy(mag.astype(np.float32)).mean()
    assert abs(float(torch_mean) - mean) <= 1e-6 * mean


def test_wrappers_on_the_cpu():
    """CPU tensors run the plain versions and count no launch; the tracker
    wrapper refuses them; the front end refuses bad shapes."""
    rng = np.random.default_rng(11)
    iq = torch.from_numpy(rng.normal(size=(2, 300, 2)).astype(np.float32))
    one = torch.ones(2)
    before = (frontend_cuda.LAUNCHES, frontend_cuda.AGC_LAUNCHES)
    got = frontend_cuda.frontend(iq, one, one, one * 0.1, "update", 0.5,
                                 1.0, torch.zeros(2, 400, 2),
                                 torch.tensor([0, 390], dtype=torch.int32))
    assert (frontend_cuda.LAUNCHES, frontend_cuda.AGC_LAUNCHES) == before
    assert got["out"].shape == (2, 400, 2)
    assert got["sfill"].tolist() == [300, 400]
    assert got["start"].tolist() == [100, 0]
    assert got["overflow"].tolist() == [False, True]
    with pytest.raises(ValueError, match="AGC mode"):
        frontend_cuda.frontend(iq, one, one, one, "on")
    with pytest.raises(ValueError, match="float32"):
        frontend_cuda.frontend(iq.double(), one, one, one)
    with pytest.raises(ValueError, match="together"):
        frontend_cuda.frontend(iq, one, one, one, sbuf=torch.zeros(2, 400, 2))
    sync = FeedForwardSync(sps=2, max_block=100, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ffsync_cuda.track(sync, sync.init_state(2), iq, 100)


def test_edge_margin_finds_a_channel_on_a_bin_edge(waveform, monkeypatch):
    sync = FeedForwardSync(sps=2, max_block=4096, device="cpu")
    n = 2 * 4096 + sync.history() + 64
    x = torch.from_numpy(cplx.from_np(waveform)[:n])[None].repeat(2, 1, 1)
    st = sync.init_state(2)
    # channel 1's block-start position on a subfilter edge (rate 0: every
    # segment's centre there), channel 0's a third of a bin from one
    tau0 = torch.tensor([0.5 + 1 / 384, 0.5 + 3 / 128])
    monkeypatch.setattr(sync, "_estimate",
                        lambda *a: (tau0, torch.zeros(2)))
    m = ffsync_cuda.edge_margin(sync, st, x, 4096)
    assert float(m[1]) == 0.0
    assert 0.0 < float(m[0]) <= 1 / 384 + 1e-7
