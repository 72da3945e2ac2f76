"""The PL sync + demap kernels' plain versions (``ops/plsync_cuda.py``)
against the JAX package, and the contracts the kernels share with them.

- ``coarse_autocorr`` (the PLHEADER kernel's plain form on a CPU tensor)
  against the JAX ``plsync.coarse_autocorr`` at N = 90 and 26: within 1e-5
  of the largest magnitude (float32 sums in another order than XLA's
  grouped convolution);
- the port's ``make_lane_fn`` on the CPU (``plheader_plain`` then
  ``payload_plain``) against the JAX lane function
  (``dvbs2rx_tpu/parallel/batch.py:63``, vmapped over lanes) for QPSK,
  8PSK, 16APSK and 32APSK short frames, pilots on and off, with mixed
  coarse_corrected and N0 overrides: metric and n0 within rtol 1e-5, fine
  within 1e-9 absolute, autocorr within 1e-5 of its largest magnitude,
  frame 0's corrected symbols within 1e-5; the int8 LLRs equal to the JAX
  float LLRs quantized, except at a rounding tie (within 4 float32 spacings
  plus rel x |v| of x.5, rel the lane's measured n0 difference), by at
  most 1, and counted;
- the in-place read: per-lane starts into one symbol buffer, clamped at
  both ends, give exactly what the stacked windows give;
- VCM's masked writes: per expected PLS, the selected lanes' int8 LLRs in
  the (B, n_ldpc) queue layout with zero padding, the snapshots, fine and
  N0, exactly as the per-PLS lane program with ``torch.where`` merges gave
  them before (``_present_lanes`` below).

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import plsync as jplsync
from dvbs2rx_tpu.parallel.batch import make_lane_fn as jmake_lane_fn
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig

from dvbs2rx_tpu_torch.ops import cplx, plsync, plsync_cuda
from dvbs2rx_tpu_torch.ops.demap import (
    demap,
    estimate_snr_generic,
    estimate_snr_qpsk,
    quantize_llrs,
)
from dvbs2rx_tpu_torch.parallel.batch import make_lane_fn
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import _window
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
from dvbs2rx_tpu_torch.spec.fec_params import DVBS2_MODCODS
from dvbs2rx_tpu_torch.spec.pls import make_pls
from dvbs2rx_tpu_torch.spec.scramblers import pl_descrambling_sequence
from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig

torch.set_num_threads(2)
C, F = 2, 2                  # B = 4 lanes
AUTO_TOL = 1e-5              # relative to the largest |r|
MODCODS = ("qpsk1/2", "8psk3/5", "16apsk2/3", "32apsk3/4")


def _rng_headers(rng, shape):
    return rng.standard_normal(shape + (90, 2)).astype(np.float32)


@pytest.mark.parametrize("full", [True, False])
def test_coarse_autocorr_matches_jax(full):
    rng = np.random.default_rng(11 + full)
    hdr = _rng_headers(rng, (3, 5))
    pls = rng.integers(0, 128, (3, 5))
    want = np.asarray(jplsync.coarse_autocorr(jnp.asarray(hdr),
                                              jnp.asarray(pls), full=full))
    got = plsync.coarse_autocorr(torch.from_numpy(hdr),
                                 torch.from_numpy(pls), full=full).numpy()
    assert got.shape == want.shape == (3, 5, 89 if full else 25, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=AUTO_TOL * np.abs(want).max())


def _lane_inputs(modcod, pilots, seed):
    """Frame-aligned noisy symbols of C channels from the port's Tx (own
    noise, phase and a small CFO each), cut as the lane-major inputs
    ((91, 2, C, F+1) headers, (Lp, 2, C, F) payloads), with the config's
    keywords."""
    cfg_kw = dict(modcod=modcod, frame_size="short", pilots=pilots)
    tx = Transmitter(TxConfig(**cfg_kw))
    L = tx.cfg.pls_info.plframe_len
    rng = np.random.default_rng(seed)
    syms = []
    for c in range(C):
        n_pkts = ((F + 2) * tx.df_bytes) // 188 + 2
        pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
        pkts[:, 0] = 0x47
        s = Transmitter(tx.cfg).modulate_ts(pkts.reshape(-1))
        s = s[: (F + 1) * L + 91]
        n = np.arange(s.size)
        rot = np.exp(1j * (rng.uniform(-3, 3) + 2e-5 * (c - 0.5) * n))
        noise = rng.normal(0, 0.12, s.shape + (2,))
        syms.append((s * rot + noise[..., 0] + 1j * noise[..., 1])
                    .astype(np.complex64))
    syms = np.stack(syms)
    Lp = tx.cfg.pls_info.payload_len
    idx_h = np.arange(F + 1)[:, None] * L + np.arange(-1, 90)[None, :]
    idx_h = np.clip(idx_h, 0, syms.shape[1] - 1)
    hdr = cplx.from_np(syms[:, idx_h]).transpose(2, 3, 0, 1)
    idx_p = 90 + np.arange(F)[:, None] * L + np.arange(Lp)[None, :]
    pay = cplx.from_np(syms[:, idx_p]).transpose(2, 3, 0, 1)
    return cfg_kw, np.ascontiguousarray(hdr), np.ascontiguousarray(pay)


def _assert_ties(q, want_q, v, rel):
    """int8 LLRs ``q`` equal ``want_q`` except where the float value ``v``
    sits within 4 of its float32 spacings, plus rel x |v|, of a rounding
    tie; never by more than 1. Returns the count of such differences."""
    diff = q.astype(np.int64) - want_q.astype(np.int64)
    at = np.flatnonzero(diff)
    tie = (np.abs(np.abs(v - np.floor(v)) - 0.5)
           <= 4 * np.spacing(np.abs(v).astype(np.float32)) + np.abs(v) * rel)
    assert np.abs(diff).max(initial=0) <= 1
    assert tie.ravel()[at].all(), "an int8 LLR differs away from a tie"
    return at.size


@pytest.mark.parametrize("pilots", [False, True])
@pytest.mark.parametrize("modcod", MODCODS)
def test_lane_matches_jax(modcod, pilots):
    cfg_kw, hdr, pay = _lane_inputs(modcod, pilots,
                                       seed=MODCODS.index(modcod) + 7 * pilots)
    cfg, jcfg = RxConfig(**cfg_kw), JRxConfig(**cfg_kw)
    B = C * F
    info = cfg.pls_info
    descr = cplx.from_np(pl_descrambling_sequence(cfg.gold_code)
                         [: info.payload_len])
    cc = np.array([True, False, True, True])
    n0_ov = np.array([-1.0, 0.05, -1.0, -1.0], np.float32)
    jlane = jax.jit(jax.vmap(jmake_lane_fn(jcfg, descr),
                             in_axes=(-1, -1, -1, 0, 0)))
    jh = hdr[..., :F].reshape(91, 2, B)
    jn = hdr[..., 1:].reshape(91, 2, B)
    want = jlane(jh, jn, pay.reshape(info.payload_len, 2, B), cc, n0_ov)
    want = {k: np.asarray(v) for k, v in want.items()}

    lane = make_lane_fn(cfg, torch.from_numpy(descr))
    h = torch.from_numpy(hdr)[1:].permute(2, 3, 0, 1)        # (C, F+1, 90, 2)
    sym = torch.from_numpy(pay).permute(2, 3, 0, 1)          # (C, F, Lp, 2)
    got = lane(h[:, :F], h[:, 1:], sym, None, torch.from_numpy(cc),
               torch.from_numpy(n0_ov), x_every=F)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_allclose(got["metric"], want["metric"], rtol=1e-5)
    np.testing.assert_allclose(got["autocorr"], want["autocorr"], rtol=0,
                               atol=AUTO_TOL * np.abs(want["autocorr"]).max())
    np.testing.assert_allclose(got["fine"], want["fine"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["n0"], want["n0"], rtol=1e-5)
    np.testing.assert_allclose(got["x0"], want["xfec"][::F], rtol=0,
                               atol=1e-5)
    assert got["llrs"].dtype == np.int8
    assert got["llrs"].shape == (info.n_slots * 90 * info.n_mod, B)
    n0_use = np.where(n0_ov > 0, n0_ov, want["n0"])
    rel = np.abs(np.where(n0_ov > 0, 0.0, got["n0"] / want["n0"] - 1))
    want_q = quantize_llrs(torch.from_numpy(want["llrs"].copy())).numpy()
    ties = _assert_ties(got["llrs"].T, want_q, want["llrs"], rel[:, None])
    assert ties <= 8, ties
    assert np.all(n0_use > 0)


def _payload_args(modcod, pilots, seed, B):
    cfg = RxConfig(modcod=modcod, frame_size="short", pilots=pilots)
    info = cfg.pls_info
    rng = np.random.default_rng(seed)
    descr = torch.from_numpy(cplx.from_np(
        pl_descrambling_sequence(cfg.gold_code)[: info.payload_len]))
    ph = torch.from_numpy(rng.uniform(-3, 3, (B, 2, 2)).astype(np.float32))
    cc = torch.from_numpy(rng.random(B) < 0.7)
    n0_ov = torch.from_numpy(np.where(rng.random(B) < 0.3, 0.1, -1.0)
                             .astype(np.float32))
    return cfg, info, descr, ph, cc, n0_ov


def _run_payload(cfg, info, descr, ph, cc, n0_ov, sym, start, clamp_len,
                 sel=None, x_every=1, x_len=None):
    B = sym.shape[0] * sym.shape[1]
    N = info.n_slots * 90 * info.n_mod
    llr = torch.zeros((N, B), dtype=torch.int8)
    fine, n0 = torch.zeros(B), torch.zeros(B)
    x = torch.zeros((B // x_every, x_len or info.n_slots * 90, 2))
    plsync_cuda.FLOAT_LLRS = []
    try:
        plsync_cuda.payload(sym, start, clamp_len, descr, ph, cc, n0_ov,
                            info, cfg.constellation, cfg.rate, llr, fine, n0,
                            sel=sel, x_out=x, x_every=x_every)
        (flt, _), = plsync_cuda.FLOAT_LLRS
    finally:
        plsync_cuda.FLOAT_LLRS = None
    return llr, fine, n0, x, flt


@pytest.mark.parametrize("modcod,pilots", [("qpsk1/2", False),
                                           ("8psk3/5", True)])
def test_in_place_read_clamps_like_windows(modcod, pilots):
    """Per-lane starts into one (C, rows, 2) buffer (a view per lane), some
    before row 0 and some past rows - Lp, against the stacked windows."""
    X, Y = 2, 3
    B = X * Y
    cfg, info, descr, ph, cc, n0_ov = _payload_args(modcod, pilots, 5, B)
    Lp = info.payload_len
    rows = Lp + 700
    rng = np.random.default_rng(9)
    buf = torch.from_numpy(rng.standard_normal((X, rows, 2))
                           .astype(np.float32))
    start = torch.tensor([-40, 0, 350, 699, 700, 5000])
    sym = buf[:, None].expand(X, Y, rows, 2)
    got = _run_payload(cfg, info, descr, ph, cc, n0_ov, sym, start, Lp,
                       x_every=Y, x_len=100)
    wins = _window(buf, start.reshape(X, Y), Lp)             # (X, Y, Lp, 2)
    want = _run_payload(cfg, info, descr, ph, cc, n0_ov, wins, None, Lp,
                        x_every=Y, x_len=100)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _present_lanes(sr, si, sym, start, ph, corrected, n0_ov, sel, acc):
    """The VCM lane program of PLS ``si`` as it ran before the kernels:
    over every lane, then merged into ``acc`` (llr float, xf, fine, n0)
    with ``torch.where`` on the selected lanes."""
    info, fec = sr._infos[si], sr._fecs[si]
    const, rate = DVBS2_MODCODS[info.modcod]
    Lp = info.payload_len
    B = ph.shape[0]
    pay = _window(sym[:, 0], start.reshape(sym.shape[0], -1), sr.Lp_max)
    p = cplx.cmul(pay.reshape(B, sr.Lp_max, 2)[:, :Lp], sr._descr[:Lp])
    hdr_phase = ph[:, 0, 0]
    if info.has_pilots:
        pil = plsync.pilot_phases(p, info.n_pilots)
        fine = plsync.fine_from_pilot_phases(ph[:, 0, 1], pil, info.n_pilots)
        xfec = plsync.correct_payload_pilots(
            p, hdr_phase, pil, torch.where(corrected, fine, 0.0),
            info.n_slots, info.n_pilots)
    else:
        fine = plsync.fine_foffset_pilotless(hdr_phase, ph[:, 1, 0],
                                             info.plframe_len)
        xfec = plsync.correct_payload_pilotless(
            p, hdr_phase, torch.where(corrected, fine, 0.0))
    snr = (estimate_snr_qpsk(xfec) if const == "QPSK"
           else estimate_snr_generic(xfec, const, rate))
    n0 = 1.0 / snr.clamp(min=1e-9)
    n0_use = torch.where(n0_ov > 0, n0_ov, n0)
    llr = demap(xfec, n0_use, const, rate, quantize=False)
    llr = torch.nn.functional.pad(llr, (0, sr.n_ldpc - fec.nldpc))
    xf = xfec[:, : sr.R_SUB].reshape(-1, sr.R_SUB * 2) * sr.XF_SCALE
    return [torch.where(sel[:, None], llr, acc[0]),
            torch.where(sel[:, None], xf, acc[1]),
            torch.where(sel, fine, acc[2]), torch.where(sel, n0_use, acc[3])]


def test_vcm_masked_lanes_match_present_program():
    """Two expected PLS of different codes (normal QPSK 1/2 pilotless, n_ldpc
    64,800; short 8PSK 3/5 piloted, 16,200): each lane written once, by the
    PLS it decoded to, into the (B, n_ldpc) int8 queue layout (zero padding
    past the shorter code, zero rows for lanes that are no data frame)."""
    pls_set = (make_pls(4, False, False), make_pls(12, True, True))
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
                   pls_expected=pls_set)
    sr = VCMStreamReceiver(cfg, n_channels=C, frames_per_step=F,
                           fec_lanes=8, device="cpu")
    FP, B = sr.F_pay, sr.B_lanes
    rng = np.random.default_rng(17)
    ring = torch.from_numpy(rng.standard_normal((C, sr.N_SYM, 2))
                            .astype(np.float32))
    sym = ring[:, None].expand(C, FP, sr.N_SYM, 2)
    start = torch.from_numpy(rng.integers(-50, sr.N_SYM, B))
    ph = torch.from_numpy(rng.uniform(-3, 3, (B, 2, 2)).astype(np.float32))
    corrected = torch.from_numpy(rng.random(B) < 0.6)
    pls_l = torch.from_numpy(rng.choice([*pls_set, 7], B))
    valid = torch.from_numpy(rng.random(B) < 0.8)
    n0_ref = torch.from_numpy(np.where(rng.random((C, 2)) < 0.5, 0.2, 0.0)
                              .astype(np.float32))
    llr8 = torch.zeros((B, sr.n_ldpc), dtype=torch.int8)
    xf, fine, n0 = (torch.zeros((B, 2 * sr.R_SUB)), torch.zeros(B),
                    torch.zeros(B))
    acc = [torch.zeros((B, sr.n_ldpc)), torch.zeros((B, 2 * sr.R_SUB)),
           torch.zeros(B), torch.zeros(B)]
    for si in range(sr.S):
        n0_ov = n0_ref[:, si].repeat_interleave(FP)
        sel = valid & (pls_l == pls_set[si])
        assert 0 < int(sel.sum()) < B
        plsync_cuda.FLOAT_LLRS = []
        try:
            assert sr._demap_lanes(si, sym, start, ph, corrected, n0_ov, sel,
                                   llr8, xf, fine, n0) is None
            (flt, m), = plsync_cuda.FLOAT_LLRS
        finally:
            plsync_cuda.FLOAT_LLRS = None
        assert flt.shape == (B, sr._fecs[si].nldpc) and torch.equal(m, sel)
        acc = _present_lanes(sr, si, sym, start, ph, corrected, n0_ov, sel,
                             acc)
    assert torch.equal(llr8, quantize_llrs(acc[0]))
    assert torch.equal(xf, acc[1])
    assert torch.equal(fine, acc[2])
    assert torch.equal(n0, acc[3])
    # rows of lanes no PLS selected stay zero; QPSK lanes pad with zeros
    none = ~(valid & ((pls_l == pls_set[0]) | (pls_l == pls_set[1])))
    assert not llr8[none].any() and not xf[none].any()
    short = valid & (pls_l == pls_set[1])
    assert sr._fecs[1].nldpc < sr.n_ldpc
    assert not llr8[short, sr._fecs[1].nldpc:].any()
    assert llr8[short, : sr._fecs[1].nldpc].any()


# ---------------- the payload kernels' launch plan (csrc/plsync.cu) --------

def _cu_source():
    from pathlib import Path

    return (Path(plsync_cuda.__file__).parent.parent / "csrc"
            / "plsync.cu").read_text()


def test_launch_plan_mirrors_the_source():
    """The launch geometry constants of csrc/plsync.cu, read from the
    source, are the plan's."""
    import re

    src = _cu_source()
    cu = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert cu["kTileLanes"] == plsync_cuda.TILE_LANES
    bits, small, large = map(int, re.search(
        r"demap_tile_syms\(int n_mod\) \{\s*return n_mod <= (\d) \? (\d+) "
        r": (\d+);\s*\}", src).groups())
    for n_mod in range(2, 6):
        assert plsync_cuda.tile_syms(n_mod) == (small if n_mod <= bits
                                                else large)
    assert cu["kMaxChunks"] == plsync_cuda.MAX_CHUNKS
    assert 2 + cu["kMaxPilots"] == plsync_cuda.LANE_FLOATS
    assert cu["kPayThreads"] % 32 == 0 and cu["kHdrThreads"] == 64


@pytest.mark.parametrize("B,R,n_mod,strides,grids,along", [
    # the CCM step: 128 lanes of QPSK normal, lane-major (N, B)
    (128, 32400, 2, (128, 1), ((128, 10), (4, 127)), "lane"),
    # the VCM step's (B, n_ldpc) rows: 256 lanes, 8PSK normal
    (256, 21600, 3, (1, 64800), ((256, 10), (8, 85)), "position"),
    # a single-channel stream (B = 2), short QPSK
    (2, 8100, 2, (2, 1), ((2, 10), (1, 32)), "lane"),
    # partial lane tiles; a view with a lane stride of 3
    (37, 3240, 5, (111, 3), ((37, 10), (2, 26)), "position"),
    (200, 5400, 3, (200, 1), ((200, 10), (7, 22)), "lane"),
    # one lane: no lane to run along
    (1, 32400, 2, (1, 1), ((1, 10), (1, 127)), "position"),
])
def test_launch_plan(B, R, n_mod, strides, grids, along):
    plan = plsync_cuda.launch_plan(B, R, n_mod, 0, *strides)
    assert (plan["stats_grid"], plan["demap_grid"]) == grids
    assert plan["chunks"] * plan["chunk"] >= R > (plan["chunks"] - 1) \
        * plan["chunk"]
    assert plan["write_along"] == along
    assert plan["stage_rows"] == n_mod * plsync_cuda.tile_syms(n_mod)
    # the scratch: the (B, 16, 2) double sums, then 24 floats a lane
    assert plan["scratch_float64"] == B * 32 + B * 12
    assert plsync_cuda.launch_plan(B, R, n_mod, -1, *strides)["runs"] == 1
    assert plan["runs"] == n_mod


def test_launch_plan_chunks_fit_the_scratch():
    """Every frame's data symbols (R = 90 slots x 36-360) split into at
    most MAX_CHUNKS chunks, the last one not empty."""
    for R in range(90 * 36, 90 * 360 + 1, 90):
        plan = plsync_cuda.launch_plan(4, R, 2, -1, 4, 1)
        assert 1 <= plan["chunks"] <= plsync_cuda.MAX_CHUNKS
        assert (plan["chunks"] - 1) * plan["chunk"] < R


def _chunked_n0(xfec, constellation, rate, chunk):
    """numpy mirror of the statistics and demap kernels' N0: each chunk's
    data-aided SNR terms summed in double, the chunks' sums added in chunk
    order in double, rounded once to float32, then snr = sp / max(np,
    1e-12) and n0 = 1 / max(snr, 1e-9) in float32."""
    x = xfec.astype(np.float32)
    if constellation == "QPSK":
        s2 = np.float32(np.sqrt(0.5))
        ref = np.sign(x) * s2
        sp_t = (ref * ref).sum(-1, dtype=np.float32)
        np_t = ((x - ref) ** 2).sum(-1, dtype=np.float32)
    else:
        from dvbs2rx_tpu_torch.ops.demap import _points

        pts = _points(constellation, rate).astype(np.float32)
        d2 = ((x[..., None, :] - pts) ** 2).sum(-1, dtype=np.float32)
        dmin = d2.min(-1)
        tied = d2 == dmin[..., None]
        inv = np.float32(1) / tied.sum(-1).astype(np.float32)
        e = (pts * pts).sum(-1, dtype=np.float32)
        sp_t = (tied * (inv[..., None] * e)).sum(-1, dtype=np.float32)
        np_t = dmin
    R = x.shape[-2]
    sp = np.zeros(x.shape[0])
    npw = np.zeros(x.shape[0])
    for k in range(-(-R // chunk)):
        sl = slice(k * chunk, (k + 1) * chunk)
        sp = sp + sp_t[:, sl].astype(np.float64).sum(-1)
        npw = npw + np_t[:, sl].astype(np.float64).sum(-1)
    snr = sp.astype(np.float32) / np.maximum(npw.astype(np.float32),
                                             np.float32(1e-12))
    return np.float32(1) / np.maximum(snr, np.float32(1e-9))


@pytest.mark.parametrize("modcod,pilots", [("qpsk1/2", False),
                                           ("8psk3/5", True),
                                           ("32apsk3/4", False)])
def test_chunked_double_reduction_gives_the_plain_n0(modcod, pilots):
    """The kernels' N0 (chunk partial sums in double, reduced in a fixed
    order, rounded once) against ``payload_plain``'s float32 N0 on the
    same corrected symbols: within rtol 1e-5 (float32 sums in torch's
    order); the plan's chunks and chunks of 1 (every symbol its own)."""
    B = C * F
    cfg, info, descr, ph, cc, n0_ov = _payload_args(modcod, pilots, 21, B)
    Lp = info.payload_len
    _, _, pay = _lane_inputs(modcod, pilots, seed=24)
    sym = torch.from_numpy(pay).permute(2, 3, 0, 1)        # (C, F, Lp, 2)
    x = torch.zeros((B, info.n_slots * 90, 2))
    llr = torch.zeros((info.n_slots * 90 * info.n_mod, B), dtype=torch.int8)
    fine, n0 = torch.zeros(B), torch.zeros(B)
    plsync_cuda.payload(sym, None, Lp, descr, ph, cc, n0_ov, info,
                        cfg.constellation, cfg.rate, llr, fine, n0,
                        x_out=x)
    R = info.n_slots * 90
    for chunk in (plsync_cuda.launch_plan(B, R, 2, -1, B, 1)["chunk"], 1):
        want = _chunked_n0(x.numpy(), cfg.constellation, cfg.rate, chunk)
        np.testing.assert_allclose(n0.numpy(), want, rtol=1e-5)


def _tile_positions(tile, R, n_mod, order):
    """The codeword positions of a demap tile's stage rows, in stage
    order, as the demap kernel's write-out computes them: row j ns + q
    (interleaved: bit j of the tile's symbol q at column order_j of R rows)
    or q n_mod + j (uninterleaved: symbol order), ns the tile's symbols."""
    ts = plsync_cuda.tile_syms(n_mod)
    i0 = tile * ts
    ns = min(ts, R - i0)
    ro = np.arange(n_mod * ns)
    if order < 0:
        return i0 * n_mod + ro
    run, off = ro // ns, ro % ns
    col = (order >> (4 * run)) & 15
    return col * R + i0 + off


def _write_out(B, R, n_mod, order, l_pos, l_lane, sel, rows):
    """numpy mirror of the demap kernel's stage and write-out over the
    plan's tiles: bit j of lane b's symbol i carries b 10^6 + i n_mod + j
    + 1 into its stage row, and each tile's stage rows go to
    ``_tile_positions`` (whichever stride the kernel runs along, the
    addresses are these). Returns the flat LLR storage and the count of
    writes per element."""
    plan = plsync_cuda.launch_plan(B, R, n_mod, order, l_pos, l_lane)
    n_el = 1 + (rows - 1) * l_pos + (B - 1) * l_lane
    out = np.zeros(n_el, np.int64)
    hits = np.zeros(n_el, np.int64)
    TL, TS = plsync_cuda.TILE_LANES, plsync_cuda.tile_syms(n_mod)
    for lt in range(plan["demap_grid"][0]):
        lanes = np.arange(lt * TL, min(B, (lt + 1) * TL))
        lanes = lanes[sel[lanes]]
        for st in range(plan["demap_grid"][1]):
            i0 = st * TS
            ns = min(TS, R - i0)
            q, j = np.meshgrid(np.arange(ns), np.arange(n_mod), indexing="ij")
            ro = (j * ns + q) if order >= 0 else (q * n_mod + j)
            stage = np.zeros((n_mod * ns, len(lanes)), np.int64)
            stage[ro.ravel()] = ((lanes[None, :] * 10 ** 6)
                                 + ((i0 + q) * n_mod + j).ravel()[:, None]
                                 + 1)
            pos = _tile_positions(st, R, n_mod, order)
            idx = pos[:, None] * l_pos + lanes[None, :] * l_lane
            np.add.at(hits, idx.ravel(), 1)
            out[idx.ravel()] = stage.ravel()
    return out, hits


@pytest.mark.parametrize("const,rate", [("QPSK", "1/2"), ("8PSK", "3/5"),
                                        ("8PSK", "25/36"), ("8PSK", "2/3"),
                                        ("16APSK", "2/3"),
                                        ("32APSK", "3/4")])
@pytest.mark.parametrize("B,layout", [(2, "lane-major"), (37, "rows"),
                                      (200, "lane-major"), (37, "strided")])
def test_tile_positions_deinterleave(const, rate, B, layout):
    """Every selected lane's every LLR lands once, at the position the
    plain deinterleave gives it, whatever the partial tiles and mask;
    unselected lanes' columns and row padding stay untouched."""
    from dvbs2rx_tpu_torch.ops.demap import deinterleave_llrs
    from dvbs2rx_tpu_torch.spec.constellations import BITS_PER_SYMBOL

    n_mod = BITS_PER_SYMBOL[const]
    R = 270 + 37 * n_mod          # two and a bit tiles, ragged
    N = R * n_mod
    order = plsync_cuda._order_word(const, rate)
    rng = np.random.default_rng(B + n_mod)
    sel = rng.random(B) < 0.7
    sel[32: min(B, 64)] = False   # a tile with no selected lane
    rows = N + 5
    l_pos, l_lane = {"lane-major": (B, 1), "rows": (1, rows),
                     "strided": (3 * B, 3)}[layout]
    out, hits = _write_out(B, R, n_mod, order, l_pos, l_lane, sel, rows)
    sym_order = torch.arange(N, dtype=torch.float64)[None] + 1
    want_pos = deinterleave_llrs(sym_order, const, rate)[0].numpy()
    for b in range(B):
        idx = np.arange(rows) * l_pos + b * l_lane
        if sel[b]:
            np.testing.assert_array_equal(out[idx[:N]] - b * 10 ** 6,
                                          want_pos)
            assert (hits[idx[:N]] == 1).all()
            assert not hits[idx[N:]].any()
        else:
            assert not hits[idx].any()
