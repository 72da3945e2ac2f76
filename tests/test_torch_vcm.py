"""The port's VCM stream receiver against the JAX ``VCMStreamReceiver``.

Configuration: C = 2 channels, 2 frames per step, 8 FEC lanes, piloted
short QPSK 1/2 (PLS 17 short) and piloted short 8PSK 3/5 alternating, at
Es/N0 15 dB, one noise seed per channel, a small CFO (5e-6 per sample) and
a 2-frame coarse period so the coarse estimate fires and the closed loop
moves the rotator within the steps compared. The JAX receiver is built
once per configuration and module (its engine's receiver serves the state
tests).

Integer outputs, PLS values, positions and TS bytes must match exactly;
float statistics within rtol 1e-4 (sums in another order than XLA on the
CPU) with the absolute floors of ``tests/test_torch_stream.py``.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import cplx as jcplx
from dvbs2rx_tpu.ops import plsync as jplsync
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.vcm_stream import VCMStreamEngine as JVCMStreamEngine
from dvbs2rx_tpu.rx.vcm_stream import VCMStreamReceiver as JVCMStreamReceiver
from dvbs2rx_tpu.spec import pi2_bpsk as jpi2
from dvbs2rx_tpu.spec import pl_defs as jpl
from dvbs2rx_tpu.spec import reed_muller as jrm
from dvbs2rx_tpu.tx import TxConfig, awgn_channel
from dvbs2rx_tpu.tx.vcm import VCMTransmitter

from dvbs2rx_tpu_torch.convert import vcm_state_from_numpy, vcm_state_to_numpy
from dvbs2rx_tpu_torch.ops import plsync, plsync_cuda
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamEngine, VCMStreamReceiver
from dvbs2rx_tpu_torch.spec.pls import make_pls

torch.set_num_threads(2)

C, F, LANES, T = 2, 2, 8, 4
PLS_A = make_pls(4, True, True)      # qpsk1/2 short, pilots
PLS_B = make_pls(12, True, True)     # 8psk3/5 short, pilots
TX = (TxConfig(modcod="qpsk1/2", frame_size="short", pilots=True),
      TxConfig(modcod="8psk3/5", frame_size="short", pilots=True))
EXACT = ("locked", "sym_lost", "n_walked", "frames", "dummies", "rejected",
         "coarse_corrected", "seq", "fp_right", "overflow", "underflow")
FLOAT_ATOL = {"metric": 1e-3, "n0": 1e-6, "coarse_foffset": 1e-7,
              "fine_foffset": 1e-7, "cum_foffset": 1e-7, "n0_refined": 1e-6}
BASE = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
            pls_expected=(PLS_A, PLS_B), coarse_period=2)


def _stimulus(schedule, n_steps, seed=0, freq_offset=5e-6):
    """(C, n) complex64: one VCM waveform, a noise seed per channel, long
    enough for prime and ``n_steps`` steps of the receiver geometry."""
    vtx = VCMTransmitter(list(TX))
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (420, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    clean = vtx.ts_to_iq(pkts.reshape(-1), schedule)
    iq = np.stack([awgn_channel(clean, 15.0, sps=2, freq_offset=freq_offset,
                                seed=seed + 1 + c) for c in range(C)])
    return iq, pkts


def _n(sr, steps):
    return sr._n_fe + steps * sr.n_in


@pytest.fixture(scope="module")
def main():
    jeng = JVCMStreamEngine(JRxConfig(**BASE), n_channels=C,
                            frames_per_step=F, fec_lanes=LANES)
    sr = VCMStreamReceiver(RxConfig(**BASE), n_channels=C, frames_per_step=F,
                           fec_lanes=LANES, device="cpu")
    iq, pkts = _stimulus([0, 1], T + 2)
    assert iq.shape[1] >= _n(sr, T + 2)
    return jeng, sr, iq, pkts


def _block(sr, iq, t):
    a = sr._n_fe + t * sr.n_in
    return jcplx.from_np(iq[:, a: a + sr.n_in]).astype(np.float32)


def _assert_equal_but_ties(q, want, v, rel=0.0):
    """Quantized lanes ``q`` equal the JAX package's ``want`` except where
    the float value ``v`` sits within 4 of its own float32 spacings, plus
    ``rel`` x |v|, of a rounding tie (x.5): there an ulp or two, from XLA's
    and PyTorch's cos/sin and sums, decides the integer, and the two may
    differ by 1. ``rel`` (per lane) is the measured relative difference of
    the lane's carried refined N0, which scales its LLRs. Returns the count
    of such differences."""
    diff = q.astype(np.int64) - want.astype(np.int64)
    at = np.flatnonzero(diff)
    tie = (np.abs(np.abs(v - np.floor(v)) - 0.5)
           <= 4 * np.spacing(np.abs(v)) + np.abs(v) * rel)
    assert np.abs(diff).max(initial=0) <= 1
    assert tie.ravel()[at].all(), "an int8 lane differs away from a tie"
    assert at.size <= 4, at.size
    return at.size


def _step_a_with_floats(sr, state, iq):
    """``sr._step_a`` on the CPU, and its lanes' float LLRs (B, n_ldpc)
    before quantization (zero-padded; zero rows for lanes no PLS
    selected), read through ``plsync_cuda.FLOAT_LLRS``."""
    plsync_cuda.FLOAT_LLRS = []
    try:
        out = sr._step_a(state, iq)
        parts = plsync_cuda.FLOAT_LLRS
    finally:
        plsync_cuda.FLOAT_LLRS = None
    assert len(parts) == sr.S
    flt = torch.zeros(out[1].shape, dtype=torch.float32)
    for llr, sel in parts:
        flt[sel, : llr.shape[1]] = llr[sel]
    return (*out, flt)


def _n0_divergence(ours, theirs, lanes_per_channel):
    """Per lane, the relative difference of its channel's carried refined
    N0 (the largest over the PLS set) between two states."""
    a, b = ours.numpy(), np.asarray(theirs)
    rel = np.where(b > 0, np.abs(a / np.where(b > 0, b, 1) - 1),
                   np.where(a > 0, np.inf, 0.0))
    return np.repeat(rel.max(axis=1), lanes_per_channel)[:, None]


def _assert_state(ours, theirs, ties=0):
    """The carried states agree: floats within rtol 1e-4, integers exactly;
    the int8 queues may differ by 1 in as many entries as step A's lanes
    had rounding ties (``_assert_equal_but_ties``)."""
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        v = np.asarray(v)
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        if k in ("qllr", "qxf"):
            d = np.abs(ours[k].astype(np.int64) - v)
            assert d.max() <= 1 and int((d > 0).sum()) <= ties, k
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_geometry_and_state_layout_match_jax(main):
    jeng, sr, _, _ = main
    jsr = jeng.sr
    for a in ("n_out", "n_in", "K_max", "F_pay", "B_lanes", "B_fec", "DRAIN",
              "CAP", "N_BUF", "N_SYM", "R_SUB", "n_ldpc", "kb_max", "_n_fe",
              "_settle0", "_coarse_reapply_min"):
        assert getattr(sr, a) == getattr(jsr, a), a
    ours, theirs = sr.init_state_np(), jsr.init_state_np()
    assert {k: (v.shape, v.dtype) for k, v in ours.items()} == \
        {k: (v.shape, v.dtype) for k, v in theirs.items()}
    rng = np.random.default_rng(3)
    st = {k: (rng.integers(-9, 9, v.shape).astype(v.dtype)) for k, v in
          theirs.items()}
    back = vcm_state_to_numpy(vcm_state_from_numpy(st, "cpu"))
    for k, v in st.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    dev = vcm_state_from_numpy(st, "cpu")
    assert dev["symbuf"].shape == (C, sr.N_SYM, 2)
    assert dev["qllr"].shape == (sr.S, sr.CAP, sr.n_ldpc)


def test_prime_matches_jax(main):
    """(a) the same primed state, bit for bit in its integer leaves."""
    jeng, sr, iq, _ = main
    jstate = jeng.sr.prime(iq[:, : jeng.sr._n_fe])
    state = vcm_state_to_numpy(sr.prime(iq[:, : sr._n_fe]))
    np.testing.assert_array_equal(sr.prime_ok, jeng.sr.prime_ok)
    assert sr.prime_ok.all()
    _assert_state(state, {k: np.asarray(v) for k, v in jstate.items()})


def test_steps_match_jax_from_same_state(main):
    """(b) four steps from one JAX-primed state: every output slot, the
    integer statistics and the carried state."""
    jeng, sr, iq, _ = main
    jsr = jeng.sr
    jstate = jsr.prime(iq[:, : jsr._n_fe])
    state = vcm_state_from_numpy({k: np.asarray(v) for k, v in
                                  jstate.items()}, "cpu")
    fired = ties = 0
    for t in range(T):
        blk = _block(sr, iq, t)
        rel = _n0_divergence(state["n0_refined"], jstate["n0_refined"],
                             sr.F_pay)
        # the JAX step's two halves, so their lane tensors can be compared
        jstate, *jlanes, jstats = jsr._step_a(jstate, blk)
        jout = {"kb": [], "meta": [], "n_corr": [], "fired": []}
        jiters = []
        for fn in jsr._step_b:
            jstate, o, jstats_b = fn(jstate, *jlanes)
            for k in jout:
                jout[k].append(o[k])
            jiters.append(jstats_b["ldpc_iters"])
        jstats = dict(jstats, n0_refined=jstats_b["n0_refined"])
        state, *lanes, stats, flt = _step_a_with_floats(
            sr, state, torch.from_numpy(blk))
        # lanes: llr (int8) and xf (floats here, quantized by the JAX step
        # A; one frame per row here, lane-major in JAX), meta, sels; the
        # plain payload's float LLRs decide the ties
        for q, v, theirs, r in zip(
                (lanes[0], sr.quantize_snapshots(lanes[1])), (flt, lanes[1]),
                jlanes[:2], (rel, 0.0)):
            ties += _assert_equal_but_ties(q.numpy(), np.asarray(theirs).T,
                                           v.numpy(), r)
        for ours, theirs in zip(lanes[2:], jlanes[2:]):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        state, out, stats_b = sr._step_b(state, *lanes)
        stats = dict(stats, **stats_b)
        for si in range(sr.S):
            np.testing.assert_array_equal(out["fired"][si],
                                          np.asarray(jout["fired"][si]))
            for k in ("kb", "meta", "n_corr"):
                np.testing.assert_array_equal(
                    out[k][si].numpy(), np.asarray(jout[k][si]),
                    err_msg=f"{k}[{si}] at step {t}")
            assert int(stats["ldpc_iters"][si]) == int(np.asarray(jiters[si]))
        fired += int(sum(f.sum() for f in out["fired"]))
        for k in EXACT:
            np.testing.assert_array_equal(stats[k].numpy(),
                                          np.asarray(jstats[k]), err_msg=k)
        for k, atol in FLOAT_ATOL.items():
            np.testing.assert_allclose(stats[k].numpy(),
                                       np.asarray(jstats[k]), rtol=1e-4,
                                       atol=atol, err_msg=k)
        _assert_state(vcm_state_to_numpy(state),
                      {k: np.asarray(v) for k, v in jstate.items()},
                      ties=ties)
    assert fired >= 2 and bool(stats["locked"].all())
    # the coarse estimate fired and the closed loop moved the rotator
    assert bool(stats["coarse_corrected"].all())
    assert float(stats["cum_foffset"].abs().min()) > 0
    assert (stats["n0_refined"].numpy() > 0).any()


def _engines(cfg_kw, iq, n):
    jeng = JVCMStreamEngine(JRxConfig(**cfg_kw), n_channels=C,
                            frames_per_step=F, fec_lanes=LANES)
    eng = VCMStreamEngine(RxConfig(**cfg_kw), n_channels=C,
                          frames_per_step=F, fec_lanes=LANES, device="cpu")
    return jeng, jeng.receive(iq[:, :n]), eng, eng.receive(iq[:, :n])


def _assert_same_engine_result(jeng, jts, eng, ts):
    for c in range(C):
        np.testing.assert_array_equal(ts[c], jts[c])
    for k in ("frame_cnt", "dummy_cnt", "rejected_cnt", "bch_frames",
              "bch_frame_errors", "sof_cnt", "ldpc_frames", "unlock_cnt"):
        assert getattr(eng.stats, k) == getattr(jeng.stats, k), k
    assert eng._per_pls == jeng._per_pls
    assert eng.gaps_skipped == jeng.gaps_skipped
    ours, theirs = eng.get_stats(), jeng.get_stats()
    for sec in ("plsync", "fec"):
        for pls, v in theirs[sec]["per_pls"].items():
            w = ours[sec]["per_pls"][pls]
            assert {k: x for k, x in w.items() if k != "snr"} == \
                {k: x for k, x in v.items() if k != "snr"}
            if v.get("snr") is not None:
                assert abs(w["snr"] - v["snr"]) < 1e-3
    assert ours["mpeg-ts"] == theirs["mpeg-ts"]


def test_engine_ts_matches_jax(main):
    """(c) ``receive`` with flush: the same TS bytes and counters."""
    jeng, _, iq, pkts = main
    eng = VCMStreamEngine(RxConfig(**BASE), n_channels=C, frames_per_step=F,
                          fec_lanes=LANES, device="cpu")
    n = _n(eng.sr, T + 2)
    jts = jeng.receive(iq[:, :n])
    ts = eng.receive(iq[:, :n])
    _assert_same_engine_result(jeng, jts, eng, ts)
    assert eng.stats.bch_frame_errors == 0
    for c in range(C):
        o = ts[c].reshape(-1, 188)
        assert o.shape[0] >= 60
        k = int(np.where((pkts == o[0]).all(axis=1))[0][0])
        np.testing.assert_array_equal(o, pkts[k: k + o.shape[0]])


def test_engine_dummies_and_rejects_match_jax():
    """(d) dummy frames in the schedule and a ``pls_list`` that rejects the
    8PSK frames: the same counters and TS bytes."""
    kw = dict(BASE, pls_list=(PLS_A,))
    iq, _ = _stimulus([0, -1, 1, -1], 5, seed=7, freq_offset=0.0)
    n = _n(VCMStreamReceiver(RxConfig(**kw), C, F, LANES, device="cpu"), 5)
    jeng, jts, eng, ts = _engines(kw, iq, n)
    _assert_same_engine_result(jeng, jts, eng, ts)
    assert eng.stats.dummy_cnt >= 10 and eng.stats.rejected_cnt >= 5
    assert eng._per_pls[1]["fec_frames"] == 0
    assert ts[0].size >= 188 * 20


def test_reacquire_matches_jax(main):
    """(e) masked re-acquisition of channel 0 from the latest n_fe raw
    samples, spliced into a carried state."""
    jeng, sr, iq, _ = main
    jsr = jeng.sr
    jstate = jsr.prime(iq[:, : jsr._n_fe])
    state = vcm_state_from_numpy({k: np.asarray(v) for k, v in
                                  jstate.items()}, "cpu")
    a = jsr._n_fe + jsr.n_in
    tail = jcplx.from_np(iq[:, a: a + jsr._n_fe]).astype(np.float32)
    mask = np.asarray([True, False])
    jnew, jok = jsr.reacquire(jstate, tail, mask)
    new, ok = sr.reacquire(state, torch.from_numpy(tail),
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.numpy().tolist() == [True, False]
    _assert_state(vcm_state_to_numpy(new),
                  {k: np.asarray(v) for k, v in jnew.items()})


def _headers(kind, n=48, seed=0):
    """(n, 90, 2) planar PLHEADERs: encoded PLS values with noise, a phase
    and a frequency ramp, or random symbols."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(n, 90, 2)).astype(np.float32)
    pls = rng.integers(0, 128, n)
    hdr = np.stack([
        jpi2.map_bpsk(np.concatenate(
            [jpl.SOF_BITS, jrm.encode(int(p)) ^ jpl.PLSC_SCRAMBLER_BITS]))
        for p in pls])
    k = np.arange(90)
    rot = np.exp(1j * (rng.uniform(-np.pi, np.pi, (n, 1)) + 2e-3 * k))
    noise = rng.normal(0, 0.45, (n, 90)) + 1j * rng.normal(0, 0.45, (n, 90))
    return jcplx.from_np((hdr * rot + noise).astype(np.complex64))


@pytest.mark.parametrize("kind", ["encoded", "random"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["soft", "hard", "diff"])
def test_plsc_decode_modes_match_jax(mode, masked, kind):
    """(f) the three PLSC decode modes: the same index (first maximum on a
    tie, -inf outside the mask) and the same scores."""
    hdr = _headers(kind)
    mask = np.zeros(128, bool)
    mask[[0, 1, 2, 3, PLS_A, PLS_B, 40, 77, 101]] = True
    mask_t = torch.from_numpy(mask) if masked else None
    if mode != "diff":      # the coherent modes see a derotated header
        hdr = np.array(jplsync.derotate_plheader(hdr, np.float32(0.0),
                                                 False))
    jp, js = getattr(jplsync, f"plsc_decode_{mode}")(
        hdr, enabled_mask=mask if masked else None)
    p, s = getattr(plsync, f"plsc_decode_{mode}")(torch.from_numpy(hdr),
                                                  enabled_mask=mask_t)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert p.dtype == torch.int32
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    if masked:
        assert mask[p.numpy()].all()


@pytest.mark.parametrize("foffset,apply_freq", [(0.0, False), (3e-3, True),
                                                (3e-3, False)])
def test_derotate_plheader_and_sof_phase_match_jax(foffset, apply_freq):
    hdr = _headers("encoded", seed=4)
    want = np.asarray(jplsync.derotate_plheader(
        hdr, np.float32(foffset), apply_freq))
    got = plsync.derotate_plheader(torch.from_numpy(hdr), foffset, apply_freq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(plsync.sof_phase(torch.from_numpy(hdr)).numpy(),
                               np.asarray(jplsync.sof_phase(hdr)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(BASE, acm_vcm=False),
    dict(BASE, sym_sync_impl="gardner"),
    dict(BASE, closed_loop=False),
    dict(BASE, pls_expected=()),
    dict(BASE, pls_expected=(PLS_A, 0)),
])
def test_constructor_raises_like_jax(kw):
    """(g) the configurations the JAX constructor refuses."""
    with pytest.raises(ValueError) as jerr:
        JVCMStreamReceiver(JRxConfig(**kw), n_channels=1)
    with pytest.raises(ValueError) as err:
        VCMStreamReceiver(RxConfig(**kw), n_channels=1, device="cpu")
    assert str(err.value) == str(jerr.value)
