"""The port's CCM stream step on a piloted 16APSK 3/4 carrier, its lane
program against the benchmark's plain payload reference, and the step's
LDPC counters.

- ``StreamReceiver`` at 16APSK 3/4 with pilots, short FECFRAMEs (C = 2,
  F = 2, 6 steps, Es/N0 16 dB): every frame decodes to the transmitted
  stream in order, and ``make_scan_step(6)`` gives the same bytes and
  statistics; stepped from the JAX ``StreamReceiver``'s primed state, it
  gives the JAX receiver's bytes, and its statistics and state within
  ``tests/test_torch_stream.py``'s tolerances.
- ``parallel.batch.make_lane_fn`` (its CPU form, the plain versions of the
  PL sync kernels) against ``rxbench/reference/payload.py`` (float64) on 2
  normal piloted 16APSK 3/4 frames at Es/N0 13 dB with a CFO of 1e-4
  cycles a symbol (inside the pilot-mode range of 3.39e-4): int8 LLRs
  equal but for +-1 ties, at most ``MAX_TIES`` of them (1 on this
  stimulus); fine CFO within ``FINE_TOL`` cycles a symbol (1.1e-11 read);
  N0 within ``N0_RTOL`` (1.9e-7 read); the refined SNR within
  ``N0_RTOL``. The tolerances separate: the reference fed bfloat16
  symbols (4,530 ties, N0 off by 1.7e-4) or with ring ratio 3.15 (rate
  2/3's; LLRs off by up to 3) fails them.
- ``ldpc_frame_iters`` and ``ldpc_converged`` equal the per-frame outputs
  of the decoder the step called, summed: stepwise, in a scan (one scalar
  a call) and merged by sum over a two-shard CPU mesh.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu_torch.ops import cplx
from dvbs2rx_tpu_torch.parallel.batch import make_channel_mesh, make_lane_fn
from dvbs2rx_tpu_torch.rx.receiver import (
    FECStage,
    RxConfig,
    _snr_refine_n0,
)
from dvbs2rx_tpu_torch.rx.stream import CALL_SUMS, StreamReceiver
from dvbs2rx_tpu_torch.tx.transmitter import (
    Transmitter,
    TxConfig,
    awgn_channel,
)
from rxbench.reference import payload as ref
from rxbench.txref.constellations import constellation_points
from rxbench.txref.transmitter import Transmitter as RefTransmitter
from rxbench.txref.transmitter import TxConfig as RefTxConfig

torch.set_num_threads(2)

MODCOD = "16apsk3/4"
PLS = 77                        # MODCOD 19 (16APSK 3/4), normal, pilots
C, F, T = 2, 2, 6
MAX_TIES = 1e-4                 # +-1 ties, as a share of the LLRs
FINE_TOL = 1e-10                # cycles a symbol
N0_RTOL = 1e-5


def _rx(frame_size, esn0_db, freq_offset=0.0, seed=0):
    """A short-frame receiver and C channels of the port's transmitter's
    IQ, each with its own noise."""
    cfg = RxConfig(modcod=MODCOD, frame_size=frame_size, pilots=True,
                   sym_sync_impl="ffw", fec_batch=C * F)
    sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F,
                        device="cpu")
    tx = Transmitter(TxConfig(modcod=MODCOD, frame_size=frame_size,
                              pilots=True, sps=2, rolloff=0.2))
    rng = np.random.default_rng(seed)
    need = sr._n_fe + T * sr.n_in + 4096
    n_pkts = (need // (2 * sr.frame_len) + 4) * tx.df_bytes // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    sent = tx.bbframes(pkts.reshape(-1))        # BB-scrambled, as delivered
    clean = tx.pulse_shape(np.concatenate(
        [tx.plframe(tx.xfecframe(tx.fecframe_bits(f))) for f in sent]))
    iq = np.stack([awgn_channel(clean, esn0_db, sps=2, phase=0.3 + c,
                                freq_offset=freq_offset, seed=seed + 1 + c)
                   for c in range(C)])
    blocks = np.stack([
        cplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                        sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
        for t in range(T)])
    return sr, iq, blocks, sent


@pytest.fixture(scope="module")
def short16():
    return _rx("short", 16.0)


def _steps(sr, iq, blocks):
    state = sr.prime(iq[:, : sr._n_fe])
    out = []
    for t in range(T):
        state, kb, stats = sr.step(state, torch.from_numpy(blocks[t]))
        out.append((kb, stats))
    return state, out


def test_stream_decodes_piloted_16apsk_in_order(short16):
    sr, iq, blocks, sent = short16
    state, steps = _steps(sr, iq, blocks)
    assert sr.payload_len == 4122 and sr.frame_len == 4212
    rows = torch.cat([kb for kb, _ in steps], dim=1).numpy()    # (C, T F, .)
    for c in range(C):
        first = np.flatnonzero((sent == rows[c, 0]).all(axis=1))
        assert first.size == 1, c
        k = int(first[0])
        np.testing.assert_array_equal(rows[c], sent[k: k + T * F])
    for _, stats in steps:
        assert bool(stats["locked"].all())
        assert int(stats["bch_errors"]) == 0
        assert bool(stats["hdr_ok"].all())
        assert int(stats["ldpc_converged"]) == C * F
    # the refined SNR: 16 dB less the matched filter's loss, ~15 dB
    snr_db = 10 * np.log10(steps[-1][1]["snr_refined"].numpy())
    assert ((snr_db > 13.5) & (snr_db < 16.5)).all(), snr_db

    scan = sr.make_scan_step(T)
    state2, kbs, sstats = scan(sr.prime(iq[:, : sr._n_fe]), blocks)
    for t, (kb, stats) in enumerate(steps):
        assert torch.equal(kbs[t], kb)
        for k, v in stats.items():
            if k not in CALL_SUMS:
                assert torch.equal(sstats[k][t], v), k
    for k in CALL_SUMS:
        want = sum(int(st[k]) for _, st in steps)
        assert int(sstats[k]) == want, k
    for k, v in state.items():
        assert torch.equal(state2[k], v), k


def test_stream_steps_match_the_jax_receiver(short16):
    """The JAX ``StreamReceiver`` on the same IQ, both stepping from its
    primed state: kbytes and the integer statistics equal, the float
    statistics (N0, refined SNR, the CFO estimates) and the carried state
    within ``tests/test_torch_stream.py``'s tolerances."""
    from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
    from dvbs2rx_tpu.rx.stream import StreamReceiver as JStreamReceiver
    from dvbs2rx_tpu_torch.convert import state_from_numpy, state_to_numpy
    from tests.test_torch_stream import EXACT, FLOAT_ATOL

    sr, iq, blocks, _ = short16
    jsr = JStreamReceiver(JRxConfig(modcod=MODCOD, frame_size="short",
                                    pilots=True, sym_sync_impl="ffw",
                                    fec_batch=C * F),
                          n_channels=C, frames_per_step=F)
    jstate = jsr.prime(iq[:, : jsr._n_fe])
    state = state_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                             "cpu")
    for t in range(T):
        jstate, jkb, jstats = jsr.step(jstate, jsr.put_iq(blocks[t]))
        state, kb, stats = sr.step(state, torch.from_numpy(blocks[t]))
        np.testing.assert_array_equal(kb.numpy(), np.asarray(jkb))
        for k in EXACT:
            np.testing.assert_array_equal(
                stats[k].numpy(), np.asarray(jstats[k]), err_msg=k)
        for k, atol in FLOAT_ATOL.items():
            np.testing.assert_allclose(
                stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4,
                atol=atol, err_msg=k)
    assert bool(stats["locked"].all()) and int(stats["bch_errors"]) == 0
    got = state_to_numpy(state)
    for k, v in jstate.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------- the lane program against the plain reference ----------

@pytest.fixture(scope="module")
def frames():
    return apsk_frames()


def apsk_frames():
    """Three normal piloted 16APSK 3/4 PLFRAMEs of the benchmark's own
    transmitter at symbol rate, a CFO of 1e-4 cycles a symbol, a phase of
    0.7 rad and AWGN at Es/N0 13 dB: (symbols, the PLFRAME length, the
    first two codewords)."""
    tx = RefTransmitter(RefTxConfig(modcod=MODCOD, frame_size="normal",
                                    pilots=True, sps=2, rolloff=0.2))
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 256, (3 * tx.df_bytes // 188 + 2, 188),
                      dtype=np.uint8)
    pk[:, 0] = 0x47
    cws = [tx.fecframe_bits(f) for f in tx.bbframes(pk.reshape(-1))[:3]]
    syms = np.concatenate([tx.plframe(tx.xfecframe(c)) for c in cws])
    n = np.arange(syms.size)
    noise = (rng.normal(size=n.size) + 1j * rng.normal(size=n.size)) * \
        np.sqrt(10 ** (-13.0 / 10) / 2)
    y = (syms * np.exp(1j * (2 * np.pi * 1e-4 * n + 0.7)) + noise)
    return y.astype(np.complex64), syms.size // 3, np.stack(cws[:2])


def apsk_lane(y, L, cc, n0_ov, device="cpu"):
    """The port's lane program over 2 lanes (X = 1, Y = 2) of one symbol
    buffer, the payloads read in place at rows 90 and L + 90; and its FEC
    stage."""
    cfg = RxConfig(modcod=MODCOD, frame_size="normal", pilots=True,
                   sym_sync_impl="ffw", fec_batch=2)
    fec = FECStage(cfg, device)
    yy = torch.from_numpy(cplx.from_np(y).astype(np.float32)).to(device)
    cc, n0_ov = cc.to(device), n0_ov.to(device)
    own = torch.stack([yy[0:90], yy[L: L + 90]])[None]
    nxt = torch.stack([yy[L: L + 90], yy[2 * L: 2 * L + 90]])[None]
    sym = yy[None, None].expand(1, 2, *yy.shape)
    start = torch.tensor([90, L + 90], device=device)
    out = make_lane_fn(cfg, fec.descr)(own, nxt, sym, start, cc, n0_ov,
                                       x_every=1)
    return {k: v.cpu() for k, v in out.items()}, fec


def apsk_gaps(out, want):
    """The lane outputs' gaps to the reference: +-1 ties and the largest
    LLR gap, fine CFO (absolute) and N0 (relative)."""
    d = out["llrs"].t().to(torch.int64) - want["llrs"].to(torch.int64)
    return {"ties": int((d != 0).sum()), "max": int(d.abs().max()),
            "fine": float((out["fine"].double() - want["fine"]).abs().max()),
            "n0": float((out["n0"].double() / want["n0"] - 1).abs().max())}


def apsk_within(g, n_llrs):
    return (g["max"] <= 1 and g["ties"] <= MAX_TIES * n_llrs
            and g["fine"] <= FINE_TOL and g["n0"] <= N0_RTOL)


@pytest.mark.parametrize("cc,n0_carried", [((True, True), (-1.0, -1.0)),
                                           ((True, False), (0.05, -1.0))])
def test_lane_program_matches_the_plain_reference(frames, cc, n0_carried):
    y, L, cws = frames
    out, _ = apsk_lane(y, L, torch.tensor(cc), torch.tensor(n0_carried))
    pair = torch.from_numpy(np.stack([y[:L], y[L: 2 * L]]))
    want = ref.frame_payload(pair, PLS, torch.tensor(n0_carried),
                             torch.tensor(cc))
    g = apsk_gaps(out, want)
    assert apsk_within(g, want["llrs"].numel()), g
    x = out["x0"].double()
    assert (torch.complex(x[..., 0], x[..., 1]) - want["xfec"]).abs().max() \
        < 1e-5
    # the post-decoder refinement on the transmitted codewords
    snr, _ = _snr_refine_n0(out["x0"], torch.from_numpy(cws),
                            "16APSK", "3/4", 4, torch.zeros(2))
    snr_ref, _ = ref.snr_refine(want["xfec"], cws, PLS)
    assert ((snr.double() / snr_ref - 1).abs() <= N0_RTOL).all()
    # 13 dB, ~2% raw bit errors in the reference's hard decisions where
    # the fine CFO's ramp is applied
    raw = ((want["llrs"].numpy() < 0) != cws).mean(axis=1)
    assert (raw[list(cc)] < 0.04).all(), raw


@pytest.mark.parametrize("fault", ["bfloat16", "gamma_3.15"])
def test_the_tolerances_refuse_a_lesser_reference(frames, fault):
    y, L, _ = frames
    out, _ = apsk_lane(y, L, torch.tensor([True, True]),
                       torch.tensor([-1.0, -1.0]))
    pair = torch.from_numpy(np.stack([y[:L], y[L: 2 * L]]))
    if fault == "bfloat16":
        planar = torch.from_numpy(cplx.from_np(pair.numpy()))
        want = ref.frame_payload(planar.to(torch.bfloat16).double(), PLS)
    else:
        want = ref.frame_payload(pair, PLS, gamma=3.15)
    assert not apsk_within(apsk_gaps(out, want), want["llrs"].numel())


def test_reference_tables():
    got = ref.apsk16_points(2.85).numpy().astype(np.complex64)
    np.testing.assert_array_equal(got, constellation_points("16APSK", "3/4"))
    assert abs((ref.apsk16_points(3.15).abs() ** 2).mean() - 1) < 1e-12
    tx = RefTransmitter(RefTxConfig(modcod=MODCOD, frame_size="normal",
                                    pilots=True))
    np.testing.assert_allclose(ref.header_symbols(PLS).numpy(),
                               tx.plframe(np.zeros(16200, np.complex64))[:90],
                               atol=1e-7)


# ---------------- the LDPC counters ----------------

class _Recorder:
    """The decoder's ``decode_frames``, keeping each call's per-frame
    iterations and convergence."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, llrsT):
        out = self.fn(llrsT)
        self.calls.append((out[2].clone(), out[3].clone()))
        return out

    def sums(self, a=0, b=None):
        got = self.calls[a:b]
        return (sum(int(i.sum()) for i, _ in got),
                sum(int(c.sum()) for _, c in got))


@pytest.fixture(scope="module")
def short13():
    return _rx("short", 12.5, seed=5)


def test_ldpc_counters_sum_the_decoders_frames(short13, monkeypatch):
    sr, iq, blocks, _ = short13
    rec = _Recorder(sr.fec.ldpc.decode_frames)
    monkeypatch.setattr(sr.fec.ldpc, "decode_frames", rec)
    _, steps = _steps(sr, iq, blocks)
    assert len(rec.calls) == T
    for t, (_, stats) in enumerate(steps):
        it, conv = rec.sums(t, t + 1)
        assert int(stats["ldpc_frame_iters"]) == it
        assert int(stats["ldpc_converged"]) == conv
        assert int(stats["ldpc_iters"]) == int(rec.calls[t][0].max())
        assert stats["ldpc_frame_iters"].dtype == torch.int32
    total = rec.sums()
    assert total[0] > T * C * F          # more than one iteration a frame
    _, _, sstats = sr.make_scan_step(T)(sr.prime(iq[:, : sr._n_fe]), blocks)
    assert rec.sums(T) == total
    assert (int(sstats["ldpc_frame_iters"]),
            int(sstats["ldpc_converged"])) == total

    mesh = make_channel_mesh(["cpu"] * 2)
    msr = StreamReceiver(sr.cfg, n_channels=C, frames_per_step=F, mesh=mesh)
    state = msr.prime(iq[:, : msr._n_fe])
    got = [0, 0]
    for t in range(T):
        state, _, mstats = msr.step(state, blocks[t])
        got[0] += int(mstats["ldpc_frame_iters"])
        got[1] += int(mstats["ldpc_converged"])
        assert mstats["ldpc_frame_iters"].dtype == torch.int32
    assert tuple(got) == total
    _, _, mscan = msr.make_scan_step(T)(msr.prime(iq[:, : msr._n_fe]),
                                        blocks)
    assert (int(mscan["ldpc_frame_iters"]),
            int(mscan["ldpc_converged"])) == total
