"""On-card tier of the PyTorch/CUDA port: kernels against their plain
versions, and the stream step on the card against the same step on the CPU.

Every test is marked ``cuda`` and skips without a card. This file imports
no jax, so it runs on a machine without JAX; ``tests/conftest.py`` does
import jax, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the LDPC kernel and every integer output of the stream step
are bit-exact; the matched filter within 1e-5 absolute on unit-variance
inputs with 1 to 64 taps scaled by 1/sqrt(L) (float32 sums in another
order); the stream step's
float statistics within rtol 1e-4 (card vs CPU float32 arithmetic).
"""

import functools

import numpy as np
import pytest
import torch

from dvbs2rx_tpu_torch.spec import bch_spec
from dvbs2rx_tpu_torch.spec.ldpc_tables import available_tables, get_code
from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch._build import launch_counts
from dvbs2rx_tpu_torch.convert import state_to_numpy, state_from_numpy
from dvbs2rx_tpu_torch.ops import (
    bch, bch_cuda, cplx, crc8_cuda, fir_cuda, ldpc_cuda)
from dvbs2rx_tpu_torch.ops.bch import BCHDecoder
from dvbs2rx_tpu_torch.ops.crc8_dev import packet_validity, packet_validity_plain
from dvbs2rx_tpu_torch.ops.encode import get_device_encoder
from dvbs2rx_tpu_torch.ops.ldpc import LDPCDecoder
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import CALL_SUMS, StreamReceiver

from chip_smoke import (WALK_MODES, WALK_TOL, _books_diff, _gardner_waveform,
                        _make_vcm_stimulus, _payload_case, _plheader_case,
                        _plsync_small, _snr_inputs, _walk_states)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dvbs2rx_tpu_torch.utils.runtime import exact_fp32

    exact_fp32()
    return torch.device("cuda")


@pytest.mark.parametrize("C,S,seg_len,L,off", [
    (4, 15, 333, 21, 23),       # ragged last tile
    (2, 1, 1000, 21, 16),       # one segment
    (3, 4, 256, 37, 9),         # exact tiles, longer filter
])
def test_mf_kernel_matches_plain(card, C, S, seg_len, L, off):
    rng = np.random.default_rng(seg_len)
    n = (S * seg_len - 1) * 2 + L + off + 3
    x = torch.from_numpy(rng.normal(size=(C, n, 2)).astype(np.float32)).to(card)
    taps = torch.from_numpy(
        (rng.normal(size=(C, S, L)) / np.sqrt(L)).astype(np.float32)).to(card)
    base = torch.from_numpy(
        rng.integers(-3, off + 4, (C, S)).astype(np.int32)).to(card)
    before = fir_cuda.LAUNCHES
    key = (C, n, S, seg_len, L, 2, off)
    shape_before = fir_cuda.LAUNCH_SHAPES.get(key, 0)
    got = fir_cuda.mf_segmented(x, taps, base, 2, seg_len, off)
    assert fir_cuda.LAUNCHES == before + 1
    assert fir_cuda.LAUNCH_SHAPES[key] == shape_before + 1
    want = fir_cuda.mf_segmented_plain(x, taps, base, 2, seg_len, off)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _mf_inputs(card, C, S, seg_len, L, sps, off, odd_n, seed):
    rng = np.random.default_rng(seed)
    n = (S * seg_len - 1) * sps + L + off + 3
    n += (n % 2) != odd_n
    assert n % 2 == odd_n
    x = torch.from_numpy(rng.normal(size=(C, n, 2)).astype(np.float32)).to(card)
    taps = torch.from_numpy(
        (rng.normal(size=(C, S, L)) / np.sqrt(L)).astype(np.float32)).to(card)
    base = torch.from_numpy(
        rng.integers(-3, off + 4, (C, S)).astype(np.int32)).to(card)
    return x, taps, base


def _mf_one_launch(*args):
    before = fir_cuda.LAUNCHES
    got = fir_cuda.mf_segmented(*args)
    assert fir_cuda.LAUNCHES == before + 1
    return got


@pytest.mark.parametrize("C,S,seg_len,L,sps,odd_n", [
    (3, 4, 500, 21, 2, 1),      # odd n: odd rows start 8 B off 16 B
    (4, 6, 13, 21, 2, 1),       # seg_len under one chunk, not a multiple of 8
    (2, 3, 2051, 21, 2, 0),     # three chunks, ragged last, odd seg_len
    (2, 5, 1001, 37, 2, 1),     # odd seg_len: 8-byte output stores
    (2, 3, 700, 64, 2, 0),      # the largest filter
    (2, 4, 300, 1, 2, 1),       # one tap
    (3, 4, 500, 21, 3, 0),      # the generic body
    (2, 3, 999, 64, 3, 1),
    (2, 2, 400, 11, 1, 1),
    (16, 15, 3000, 21, 2, 0),   # more items than the persistent grid
])
def test_mf_redesign_cases_match_plain(card, C, S, seg_len, L, sps, odd_n):
    off = 23
    x, taps, base = _mf_inputs(card, C, S, seg_len, L, sps, off, odd_n,
                               seed=seg_len + L)
    plan = fir_cuda.launch_plan(C, S, seg_len, L, sps)
    lib = fir_cuda._build.lib()
    assert lib.mf_segmented_smem_bytes(L, sps) == plan.smem_bytes
    grid = lib.mf_segmented_grid_blocks(L, sps)
    assert grid > 0
    if C == 16:
        assert plan.items > grid
    got = _mf_one_launch(x, taps, base, sps, seg_len, off)
    want = fir_cuda.mf_segmented_plain(x, taps, base, sps, seg_len, off)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_mf_kernel_takes_a_noncontiguous_view(card):
    C, S, seg_len, L, off = 3, 4, 500, 21, 23
    x, taps, base = _mf_inputs(card, C, S, seg_len, L, 2, off, 1, seed=4)
    view = x.transpose(1, 2).contiguous().transpose(1, 2)  # (C, n, 2) view
    assert not view.is_contiguous()
    got = _mf_one_launch(view, taps, base, 2, seg_len, off)
    want = fir_cuda.mf_segmented_plain(x, taps, base, 2, seg_len, off)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2100, 2101])
def test_mf_decimate_on_card_with_upper_clip(card, n):
    """S = 1 through ``mf_decimate``: every start up to and past the clip
    at n - n_out*sps - L + 1."""
    rng = np.random.default_rng(n)
    C, n_out, L = 4, 1000, 21
    x = torch.from_numpy(rng.normal(size=(C, n, 2)).astype(np.float32))
    taps = torch.from_numpy(
        (rng.normal(size=(C, L)) / np.sqrt(L)).astype(np.float32))
    top = n - n_out * 2 - L + 1
    base = torch.tensor([0, 7, top, top + 50], dtype=torch.int32)
    want = fir_cuda.mf_decimate(x, taps, base, 2, n_out)
    before = fir_cuda.LAUNCHES
    got = fir_cuda.mf_decimate(x.to(card), taps.to(card), base.to(card), 2,
                               n_out)
    assert fir_cuda.LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def _llrs(code, B, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(-25, 26, (B, code.N), dtype=np.int8)
    bits = rng.integers(0, 2, (B, code.K), dtype=np.uint8)
    llrs = np.where(code.encode(bits) == 0, 14, -14).astype(np.int8)
    flip = rng.random((B, code.N)) < 0.02
    return np.where(flip, -llrs, llrs).astype(np.int8)


@pytest.mark.parametrize("table,B,kind,trials", [
    ("S2_C4", 8, "random", 4), ("S2_C4", 8, "converging", 10),
    ("S2_C1", 5, "random", 3), ("S2_C10", 3, "converging", 25),
    ("S2_B4", 6, "converging", 25),
    ("S2_B4", 128, "converging", 25),    # the main path's batch
    ("S2_B1", 16, "converging", 25),     # the tightest shared-memory
    ("S2_B2", 16, "converging", 25),     # layouts (3-byte words)
    ("S2_B11", 8, "random", 4),          # 8-byte words, E = 30
    ("S2X_C7", 8, "converging", 25),     # 4-byte words
])
def test_ldpc_kernel_matches_plain(card, table, B, kind, trials):
    code = get_code(table)
    llrs = _llrs(code, B, kind, seed=B)
    xT = torch.from_numpy(np.ascontiguousarray(llrs.T)).to(card)
    before = ldpc_cuda.LAUNCHES
    shape_before = ldpc_cuda.LAUNCH_SHAPES.get((table, B, trials), 0)
    got = ldpc_cuda.CudaLDPCDecoder(code, trials, card).decode_lane_major(xT)
    assert ldpc_cuda.LAUNCHES == before + 1
    assert ldpc_cuda.LAUNCH_SHAPES[(table, B, trials)] == shape_before + 1
    want = LDPCDecoder(code, trials, card).decode_lane_major(xT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    rows = ldpc_cuda.CudaLDPCDecoder(code, trials, card)(
        torch.from_numpy(llrs).to(card))
    for g, w in zip(rows, LDPCDecoder(code, trials, "cpu")(
            torch.from_numpy(llrs))):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("table", available_tables())
def test_ldpc_kernel_matches_plain_on_every_table(card, table):
    """Every code table, so every template shape of the kernel (largest
    data degree, variable degrees, 3-, 4- and 8-byte message words) runs
    once against the plain decoder on the card."""
    code = get_code(table)
    x = torch.from_numpy(_llrs(code, 3, "converging", seed=1)).to(card)
    got = ldpc_cuda.CudaLDPCDecoder(code, 25, card)(x)
    want = LDPCDecoder(code, 25, card)(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_bch_and_crc_on_card_match_cpu(card):
    """The GF(2) matmuls (float32, TF32 off) and Berlekamp-Massey on the
    card, with clean, correctable and uncorrectable frames."""
    framesize, t, nbch, kbch = "short", 12, 7200, 7032
    rng = np.random.default_rng(8)
    cw = []
    for n_err in (0, 3, 12, 20):
        msg = rng.integers(0, 256, kbch // 8, dtype=np.uint8)
        par = bch_spec.bch_encode_bytes(msg, framesize, t)
        bits = np.concatenate([np.unpackbits(msg), np.unpackbits(par)])
        bits[rng.choice(nbch, n_err, replace=False)] ^= 1
        cw.append(bits)
    bits_t = torch.from_numpy(np.ascontiguousarray(np.stack(cw).T))
    want = BCHDecoder(framesize, t, nbch, kbch, "cpu").decode_lane_major(bits_t)
    got = BCHDecoder(framesize, t, nbch, kbch, card).decode_lane_major(
        bits_t.to(card))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert list(want[1].numpy()[:3]) == [0, 3, 12]
    frames = torch.from_numpy(
        rng.integers(0, 256, (5, kbch // 8), dtype=np.uint8))
    for g, w in zip(packet_validity(frames.to(card)), packet_validity(frames)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_stream_step_on_card_matches_cpu(card):
    C, F, T = 2, 2, 4
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short")
    gpu = StreamReceiver(cfg, n_channels=C, frames_per_step=F, device=card)
    cpu = StreamReceiver(cfg, n_channels=C, frames_per_step=F, device="cpu")
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (200, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq1 = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 15.0, sps=2, seed=1)
    iq = np.stack([iq1] * C)
    state_c = cpu.prime(iq[:, : cpu._n_fe])
    state_g = state_from_numpy(state_to_numpy(state_c), card)
    launches = (fir_cuda.LAUNCHES, ldpc_cuda.LAUNCHES)
    for t in range(T):
        blk = cplx.from_np(iq[:, cpu._n_fe + t * cpu.n_in:
                              cpu._n_fe + (t + 1) * cpu.n_in]
                           ).astype(np.float32)
        state_c, kb_c, st_c = cpu.step(state_c, torch.from_numpy(blk))
        state_g, kb_g, st_g = gpu.step(state_g, gpu.put_iq(blk))
        np.testing.assert_array_equal(kb_g.cpu().numpy(), kb_c.numpy())
        for k in ("bch_errors", "ldpc_iters", "ts_ok", "hdr_ok", "fp",
                  "locked", "sfill"):
            np.testing.assert_array_equal(st_g[k].cpu().numpy(),
                                          st_c[k].numpy(), err_msg=k)
        for k in ("metric", "n0", "snr_refined"):
            np.testing.assert_allclose(st_g[k].cpu().numpy(), st_c[k].numpy(),
                                       rtol=1e-4, err_msg=k)
    assert fir_cuda.LAUNCHES - launches[0] == T
    assert ldpc_cuda.LAUNCHES - launches[1] == T
    assert bool(st_g["locked"].all()) and int(st_g["bch_errors"]) == 0


def _vcm_case(schedule, n_pkts, reject=False):
    """The small VCM configuration (piloted short QPSK 1/2 + 8PSK 3/5, a
    2-frame coarse period; with ``reject`` a ``pls_list`` that takes the
    QPSK frames only) and 2 channels of its waveform at 15 dB, one noise
    seed per channel, a CFO of 5e-6 per sample."""
    from dvbs2rx_tpu_torch.spec.pls import make_pls
    from dvbs2rx_tpu_torch.tx.vcm import VCMTransmitter

    pls = (make_pls(4, True, True), make_pls(12, True, True))
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
                   pls_expected=pls, coarse_period=2,
                   pls_list=pls[:1] if reject else ())
    vtx = VCMTransmitter([
        TxConfig(modcod="qpsk1/2", frame_size="short", pilots=True),
        TxConfig(modcod="8psk3/5", frame_size="short", pilots=True)])
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    clean = vtx.ts_to_iq(pkts.reshape(-1), schedule)
    iq = np.stack([awgn_channel(clean, 15.0, sps=2, freq_offset=5e-6,
                                seed=1 + c) for c in range(2)])
    return cfg, iq


def test_vcm_step_on_card_matches_cpu(card):
    """The VCM step (2 channels, piloted short QPSK 1/2 + 8PSK 3/5, 8 FEC
    lanes) on the card against the same step on the CPU: every output slot
    and integer statistic equal, floats within rtol 1e-4, the MF kernel
    launched every step and the LDPC kernel once per decoded batch."""
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    C, T = 2, 6
    cfg, iq = _vcm_case([0, 1], 420)
    gpu = VCMStreamReceiver(cfg, C, 2, fec_lanes=8, device=card)
    cpu = VCMStreamReceiver(cfg, C, 2, fec_lanes=8, device="cpu")
    state_c = cpu.prime(iq[:, : cpu._n_fe])
    state_g = {k: v.to(card) for k, v in state_c.items()}
    launches = (fir_cuda.LAUNCHES, ldpc_cuda.LAUNCHES)
    batches = 0
    for t in range(T):
        blk = cplx.from_np(iq[:, cpu._n_fe + t * cpu.n_in:
                              cpu._n_fe + (t + 1) * cpu.n_in]
                           ).astype(np.float32)
        state_c, out_c, st_c = cpu.step(state_c, torch.from_numpy(blk))
        state_g, out_g, st_g = gpu.step(state_g, gpu.put_iq(blk))
        for si in range(cpu.S):
            np.testing.assert_array_equal(out_g["fired"][si],
                                          out_c["fired"][si])
            batches += int(out_c["fired"][si].sum())
            for k in ("kb", "meta", "n_corr"):
                np.testing.assert_array_equal(out_g[k][si].cpu().numpy(),
                                              out_c[k][si].numpy(), err_msg=k)
        for k in ("locked", "n_walked", "frames", "dummies", "rejected",
                  "seq", "fp_right", "coarse_corrected"):
            np.testing.assert_array_equal(st_g[k].cpu().numpy(),
                                          st_c[k].numpy(), err_msg=k)
        for k in ("metric", "n0", "n0_refined", "cum_foffset"):
            np.testing.assert_allclose(st_g[k].cpu().numpy(), st_c[k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
    assert batches >= 2
    assert fir_cuda.LAUNCHES - launches[0] == T
    assert ldpc_cuda.LAUNCHES - launches[1] == batches
    assert bool(st_g["locked"].all())


@functools.lru_cache(maxsize=1)
def _walk_cases():
    """chip_smoke's walk cases at C = 64 on phase 6's stimulus (normal PLS
    17 + 49 at 13 dB), after 4 steps: the stream, coarse_corrected
    alternating, the estimate firing inside the walk, settling channels,
    symfill rising across the channels, first frames at the ring's edges,
    and a ring of dummy frames with every slot alive."""
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    sr = VCMStreamReceiver(_walk_cfg("coherent-soft"), 64, 2, device="cuda")
    iq, _, _ = _make_vcm_stimulus(sr, 5, "normal")
    return _walk_states(sr, iq, warm_steps=4)


def _walk_cfg(mode):
    from dvbs2rx_tpu_torch.spec.pls import make_pls

    return RxConfig(modcod="qpsk1/2", frame_size="normal", acm_vcm=True,
                    pls_expected=(make_pls(4, False, True),
                                  make_pls(12, False, True)),
                    plsc_mode=mode)


@pytest.mark.parametrize("mode", WALK_MODES)
def test_vcm_walk_kernel_matches_plain(card, mode):
    """The walk kernel (the chain walk and its books) against its plain
    composite on the card at C = 64, in each PLSC mode, on every case of
    ``_walk_cases``: the lanes, carry and counts equal, the lock and
    coarse flags equal but at named near-ties, the accumulator and metric
    sum within WALK_TOL (1e-5) of their largest magnitude
    (``chip_smoke._books_diff``); one launch per ``_walk_books``, none by
    ``_walk_books_plain``."""
    from dvbs2rx_tpu_torch.ops import vcm_walk_cuda
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    sr = VCMStreamReceiver(_walk_cfg(mode), 64, 2, device=card)
    walked, fired = {}, {}
    for case, state in _walk_cases().items():
        n0 = vcm_walk_cuda.LAUNCHES
        got = sr._walk_books(state)
        assert vcm_walk_cuda.LAUNCHES == n0 + 1
        want = sr._walk_books_plain(state)
        assert vcm_walk_cuda.LAUNCHES == n0 + 1
        err, scale, _ = _books_diff(sr, state, got, want)
        assert err["coarse_acc"] <= WALK_TOL * scale["coarse_acc"]
        walked[case] = got["n_walked"].cpu().numpy()
        fired[case] = got["new_coarse"].cpu().numpy()
    assert (walked["dummy"] == sr.K_max).all()
    assert (walked["stream"] >= 2).all()
    assert (walked["symfill_partial"] == 0).any()
    assert (walked["symfill_partial"] > 0).any()
    assert fired["fired"].all() and fired["dummy"].all()


def test_vcm_steps_launch_the_walk_kernel_and_never_the_plain_loop(
        card, monkeypatch):
    """On the card every VCM step walks and keeps its books through one
    kernel launch and never through the plain composite."""
    from dvbs2rx_tpu_torch.ops import vcm_walk_cuda
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    def plain(*args):
        raise AssertionError("the plain walk ran on the card")

    monkeypatch.setattr(VCMStreamReceiver, "_walk_plain", plain)
    monkeypatch.setattr(VCMStreamReceiver, "_walk_books_plain", plain)
    cfg, iq = _vcm_case([0, 1], 300)
    sr = VCMStreamReceiver(cfg, 2, 2, fec_lanes=8, device=card)
    state = sr.prime(iq[:, : sr._n_fe])
    n0, T = vcm_walk_cuda.LAUNCHES, 3
    for t in range(T):
        blk = cplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                              sr._n_fe + (t + 1) * sr.n_in]
                           ).astype(np.float32)
        state, _, stats = sr.step(state, sr.put_iq(blk))
    assert vcm_walk_cuda.LAUNCHES == n0 + T
    assert int(stats["n_walked"].sum()) > 0


def test_vcm_walk_wrapper_raises_on_the_card(card):
    """The kernel's wrapper refuses a non-contiguous ring, a leaf or a
    mask on another device, and launches nothing then."""
    from dvbs2rx_tpu_torch.ops import vcm_walk_cuda
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    sr = VCMStreamReceiver(_walk_cfg("coherent-soft"), 64, 2, device=card)
    state = _walk_cases()["stream"]
    args = dict(state=state, search_mask=sr._search_mask,
                enabled_mask=sr._enabled_tab, K=sr.K_max, F_pay=sr.F_pay,
                L_max=sr.L_max, mode="coherent-soft",
                coarse_period=sr.cfg.coarse_period)
    n0 = vcm_walk_cuda.LAUNCHES
    ring = state["symbuf"]
    for bad in (
            dict(state=dict(state, symbuf=ring.transpose(0, 1).contiguous()
                            .transpose(0, 1))),
            dict(state=dict(state, pls=state["pls"].cpu())),
            dict(state=dict(state, coarse_acc=state["coarse_acc"].cpu())),
            dict(search_mask=sr._search_mask.cpu()),
            dict(enabled_mask=sr._enabled_tab.cpu())):
        with pytest.raises(ValueError):
            vcm_walk_cuda.vcm_walk(**dict(args, **bad))
    assert vcm_walk_cuda.LAUNCHES == n0


def _assert_vcm_states_close(ours, theirs):
    """Integer leaves equal, the int8 queues within 1 (a rounding tie of
    the card's and the CPU's float32), floats within rtol 1e-4."""
    for k, v in theirs.items():
        if k in ("qllr", "qxf"):
            d = np.abs(ours[k].astype(np.int64) - v)
            assert d.max(initial=0) <= 1, k
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.mark.parametrize("reject", [False, True])
def test_vcm_engine_on_card_matches_cpu(card, reject):
    """``VCMStreamEngine.receive`` on the card against the same run on the
    CPU, over what a bare step bypasses: dummy frames in the schedule
    ([0, -1, 1]), with ``reject`` a ``pls_list`` that rejects the 8PSK
    frames, a forced re-acquisition of channel 0 (its timing through the MF
    kernel) and the flush's partial LDPC batches. TS bytes, counters and
    the re-acquired state agree."""
    from dvbs2rx_tpu_torch.convert import vcm_state_to_numpy
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamEngine

    C = 2
    cfg, iq = _vcm_case([0, -1, 1], 150, reject)
    engs = {d: VCMStreamEngine(cfg, C, 2, fec_lanes=8, device=d)
            for d in ("cuda", "cpu")}
    reacq, flushed = {d: [] for d in engs}, {}
    for d, eng in engs.items():
        sr = eng.sr

        def reacquire(state, tail, mask, d=d, inner=sr.reacquire):
            new, ok = inner(state, tail, mask)
            reacq[d].append((vcm_state_to_numpy(new), ok.cpu().numpy()))
            return new, ok

        def flush(state, d=d, inner=sr.flush):
            before = dict(ldpc_cuda.LAUNCHES_BY_CODE)
            out = inner(state)
            flushed[d] = {k: n - before.get(k, 0) for k, n in
                          ldpc_cuda.LAUNCHES_BY_CODE.items()}
            return out

        sr.reacquire, sr.flush = reacquire, flush
    sr = engs["cpu"].sr
    warm = sr._n_fe + (engs["cpu"]._nblk + 1) * sr.n_in
    end = warm + 5 * sr.n_in
    assert iq.shape[1] >= end
    ts = {}
    for d, eng in engs.items():
        first = eng.receive(iq[:, :warm], flush=False)
        assert not eng.need.any() and eng.reacquired == 0
        eng.need[0] = True                      # channel 0 re-acquires
        rest = eng.receive(iq[:, warm:end], flush=True)
        ts[d] = [np.concatenate([a, b]) for a, b in zip(first, rest)]
    gpu, cpu = engs["cuda"], engs["cpu"]
    for c in range(C):
        np.testing.assert_array_equal(ts["cuda"][c], ts["cpu"][c])
        assert ts["cpu"][c].size >= 188 * 20
    for k in ("frame_cnt", "dummy_cnt", "rejected_cnt", "bch_frames",
              "bch_frame_errors", "sof_cnt", "ldpc_frames", "unlock_cnt"):
        assert getattr(gpu.stats, k) == getattr(cpu.stats, k), k
    assert gpu._per_pls == cpu._per_pls
    assert (gpu.reacquired, gpu.gaps_skipped) == \
        (cpu.reacquired, cpu.gaps_skipped)
    assert cpu.reacquired >= 1 and cpu.stats.dummy_cnt > 0
    assert cpu.stats.bch_frame_errors == 0
    assert len(reacq["cuda"]) == len(reacq["cpu"]) >= 1
    for (s_g, ok_g), (s_c, ok_c) in zip(reacq["cuda"], reacq["cpu"]):
        np.testing.assert_array_equal(ok_g, ok_c)
        _assert_vcm_states_close(s_g, s_c)
    assert reacq["cpu"][0][1].tolist() == [True, False]
    fec = [f.ldpc_table for f in sr._fecs]
    if reject:
        assert cpu.stats.rejected_cnt > 0
        assert cpu._per_pls[1]["fec_frames"] == 0
    else:
        assert cpu.stats.rejected_cnt == 0
        # the flush decoded a partial batch of each code on the card
        assert all(flushed["cuda"].get(t, 0) >= 1 for t in fec), flushed


@pytest.mark.parametrize("algo,update", [("min-sum", "normal"),
                                         ("min-sum-c", "normal"),
                                         ("offset-min-sum", "self-corrected")])
def test_ldpc_variants_on_card_match_cpu(card, algo, update):
    """The plain decoder's other rules on CUDA tensors (the configured
    device's decoder, as ``get_ldpc_decoder`` routes them): bit-exact
    against the same rule on the CPU; the kernel never launches."""
    from dvbs2rx_tpu_torch.rx.receiver import get_ldpc_decoder

    code = get_code("S2_C4")
    llrs = np.concatenate([_llrs(code, 4, "random", 1),
                           _llrs(code, 4, "converging", 2)])
    dec = get_ldpc_decoder("S2_C4", 6, algo, update, card)
    assert type(dec) is LDPCDecoder
    before = ldpc_cuda.LAUNCHES
    got = [t.cpu().numpy() for t in
           dec.decode_lane_major(torch.from_numpy(llrs).to(card).t())]
    want = [t.numpy() for t in LDPCDecoder(code, 6, "cpu", algo, update)
            .decode_lane_major(torch.from_numpy(llrs).t())]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ldpc_cuda.LAUNCHES == before


def _host_pair(make, run):
    """The same host receiver run on the card and on the CPU: (card
    receiver, CPU receiver, card output, CPU output)."""
    out = {}
    for d in ("cuda", "cpu"):
        rx = make(d)
        out[d] = (rx, run(rx))
    return out["cuda"][0], out["cpu"][0], out["cuda"][1], out["cpu"][1]


HOST_INT_STATS = ("locked", "sof_cnt", "frame_cnt", "rejected_cnt",
                  "dummy_cnt", "lock_cnt", "unlock_cnt", "coarse_corrected",
                  "ldpc_frames", "ldpc_total_iters", "bch_frames",
                  "bch_frame_errors", "bch_corrections")


def _assert_host_same(g, c):
    for k in HOST_INT_STATS:
        assert getattr(g.stats, k) == getattr(c.stats, k), k
    for k in ("coarse_foffset", "fine_foffset", "cum_freq_offset"):
        np.testing.assert_allclose(getattr(g.stats, k), getattr(c.stats, k),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert g.bb_parser.stats == c.bb_parser.stats


def test_host_receiver_on_card_matches_cpu(card):
    """(a) ``make_receiver`` -> ``Receiver``, short QPSK 1/2 at 8 dB with a
    small CFO through the closed loop, two ``receive`` calls: the TS bytes
    and integer counters of the card's run equal the CPU's; the MF kernel
    ran once per front-end block, the LDPC kernel once per FEC batch."""
    from dvbs2rx_tpu_torch.rx.receiver import make_receiver

    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(3)
    pkts = rng.integers(0, 256, (12 * tx.df_bytes // 188, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 10.0, sps=2,
                      freq_offset=1e-5, seed=4)
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", coarse_period=2)
    launches = {}

    def run(rx):
        before = (fir_cuda.LAUNCHES, ldpc_cuda.LAUNCHES)
        cut = iq.size // 2
        out = np.concatenate([rx.receive(iq[:cut], flush=False),
                              rx.receive(iq[cut:])])
        launches[rx.device.type] = (fir_cuda.LAUNCHES - before[0],
                                    ldpc_cuda.LAUNCHES - before[1])
        return out

    g, c, ts_g, ts_c = _host_pair(lambda d: make_receiver(cfg, device=d),
                                  run)
    np.testing.assert_array_equal(ts_g, ts_c)
    _assert_host_same(g, c)
    assert c.stats.bch_frame_errors == 0 and ts_c.size >= 188 * 30
    assert c.stats.cum_freq_offset != 0
    n_fec = -(-c.stats.ldpc_frames // cfg.fec_batch)
    assert launches["cuda"][1] == n_fec and launches["cpu"] == (0, 0)
    assert launches["cuda"][0] > 0


def test_acm_receiver_on_card_matches_cpu(card):
    """(b) ``make_receiver`` -> ``ACMReceiver``, fully blind, on the small
    VCM waveform with dummy frames: TS bytes, integer counters and per-PLS
    counters equal on the card and on the CPU."""
    from dvbs2rx_tpu_torch.rx.receiver import make_receiver

    _, iq = _vcm_case([0, -1, 1], 150)
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", pilots=True,
                   acm_vcm=True, fec_batch=4)
    g, c, ts_g, ts_c = _host_pair(lambda d: make_receiver(cfg, device=d),
                                  lambda rx: rx.receive(iq[0]))
    np.testing.assert_array_equal(ts_g, ts_c)
    _assert_host_same(g, c)
    assert c.stats.dummy_cnt > 0 and c.stats.bch_frame_errors == 0
    fec_g, fec_c = (r.get_stats()["fec"]["per_pls"] for r in (g, c))
    assert {p: (v["frames"], v["errors"], v["avg_ldpc_trials"])
            for p, v in fec_g.items()} == \
        {p: (v["frames"], v["errors"], v["avg_ldpc_trials"])
         for p, v in fec_c.items()}
    assert len(fec_c) == 2 and ts_c.size >= 188 * 30


def test_batched_acm_receiver_on_card_matches_cpu(card):
    """(c) ``BatchedACMReceiver``, 2 channels, two ``receive`` calls: each
    channel's TS bytes and integer counters equal on the card and on the
    CPU, with every FEC batch pooled into one kernel launch."""
    from dvbs2rx_tpu_torch.rx.acm_batch import BatchedACMReceiver

    _, iq = _vcm_case([0, -1, 1], 150)
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", pilots=True,
                   acm_vcm=True, fec_batch=4)
    cut = iq.shape[1] // 2

    def run(brx):
        a = brx.receive(iq[:, :cut], flush=False)
        b = brx.receive(iq[:, cut:])
        return [np.concatenate([x, y]) for x, y in zip(a, b)]

    g, c, ts_g, ts_c = _host_pair(
        lambda d: BatchedACMReceiver(cfg, 2, device=d), run)
    for ch in range(2):
        np.testing.assert_array_equal(ts_g[ch], ts_c[ch])
        _assert_host_same(g.chans[ch], c.chans[ch])
        assert ts_c[ch].size >= 188 * 30


def _gardner_case(card, method, sps, C, n_syms):
    """A SymbolSync on the card, C channels of waveforms (one seed and delay
    each, the last one cut short so its strobes reach the window clamp) and
    distinct starting states."""
    from dvbs2rx_tpu_torch.ops.frontend import SymbolSync

    sync = SymbolSync(sps=sps, interp_method=method, device=card,
                      loop_bw=0.005 if sps == 4 else 0.01,
                      damping=0.707 if sps == 4 else 1.0)
    waves = [_gardner_waveform(n_syms, sps, seed=10 + c,
                               frac_delay=0.1 + 0.8 * c / max(C, 1))
             for c in range(C)]
    n = min(w.shape[0] for w in waves)
    x = torch.from_numpy(np.stack([w[:n] for w in waves])).to(card)
    st = sync.init_state(C)
    rng = np.random.default_rng(C)
    st.mu = torch.from_numpy(rng.uniform(0, 1, C).astype(np.float32)).to(card)
    n_out = n // sps - 20
    return sync, x, st, n_out


GARDNER_INT = ("jump", "n")
GARDNER_FLOAT = ("cnt", "mu", "vi", "last_xi")


@pytest.mark.parametrize("method", ["polyphase", "linear", "quadratic",
                                    "cubic"])
@pytest.mark.parametrize("C", [1, 8])
def test_gardner_kernel_matches_plain(card, method, C):
    """One launch of the Gardner kernel against the plain loop on the card:
    integers equal, symbols and float state within 1e-5 (the two keep the
    same float32 operations in the same order; the plain version's float64
    emulation of an FMA can round twice)."""
    from dvbs2rx_tpu_torch.ops import gardner_cuda

    sync, x, st, n_out = _gardner_case(card, method, 2, C, 700)
    before = gardner_cuda.LAUNCHES
    got_st, got = sync.step(st, x, n_out + 40)    # past the block's end
    assert gardner_cuda.LAUNCHES == before + 1
    want_st, want = gardner_cuda.symbol_sync_plain(sync, st, x, n_out + 40)
    assert int(want_st.n.min()) >= x.shape[1]      # the clamp was reached
    for k in GARDNER_INT:
        torch.testing.assert_close(getattr(got_st, k), getattr(want_st, k),
                                   rtol=0, atol=0)
    for k in GARDNER_FLOAT:
        torch.testing.assert_close(getattr(got_st, k), getattr(want_st, k),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_gardner_kernel_sps4_and_tiles(card, monkeypatch):
    """Polyphase at sps 4 (41 taps: the tree-reduction order), once with
    the whole window in one tile and once with tiles of 600 samples, which
    the walker must reload as it goes."""
    from dvbs2rx_tpu_torch.ops import gardner_cuda

    sync, x, st, n_out = _gardner_case(card, "polyphase", 4, 3, 700)
    want_st, want = gardner_cuda.symbol_sync_plain(sync, st, x, n_out)
    plan = gardner_cuda.launch_plan
    for tile in (None, 600):
        monkeypatch.setattr(gardner_cuda, "launch_plan",
                            functools.partial(plan, max_tile=tile))
        got_st, got = sync.step(st, x, n_out)
        for k in GARDNER_INT + GARDNER_FLOAT:
            torch.testing.assert_close(getattr(got_st, k),
                                       getattr(want_st, k), rtol=0,
                                       atol=1e-5)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    monkeypatch.setattr(gardner_cuda, "launch_plan", plan)


def _assert_gardner_equal(got, want):
    (got_st, got_sym), (want_st, want_sym) = got, want
    for k in GARDNER_INT:
        torch.testing.assert_close(getattr(got_st, k), getattr(want_st, k),
                                   rtol=0, atol=0)
    for k in GARDNER_FLOAT:
        torch.testing.assert_close(getattr(got_st, k), getattr(want_st, k),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(got_sym, want_sym, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sps", [2, 4])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_gardner_speculation_matches_plain(card, monkeypatch, sps, C):
    """The polyphase kernel (walker and candidate helpers) against the
    plain loop at sps 2 and 4, C = 1, 3 and 8, with the block in one tile
    and in tiles of 600 samples; the walker took most pairs from the
    helpers, and the kernel's shared memory is the plan's."""
    from dvbs2rx_tpu_torch import _build
    from dvbs2rx_tpu_torch.ops import gardner_cuda

    sync, x, st, n_out = _gardner_case(card, "polyphase", sps, C, 700)
    want = gardner_cuda.symbol_sync_plain(sync, st, x, n_out)
    plan = gardner_cuda.launch_plan
    for tile in (None, 600):
        p = plan(x.shape[1], sync.subfilt_len, sync.midpoint,
                 sync._bank.size, max_tile=tile)
        assert _build.lib().gardner_smem_bytes(p.table_floats, p.tile) \
            == p.smem_bytes
        monkeypatch.setattr(gardner_cuda, "launch_plan",
                            functools.partial(plan, max_tile=tile))
        gardner_cuda.reset_speculation_counts()
        got = sync.step(st, x, n_out)
        hits, misses = gardner_cuda.speculation_counts()
        _assert_gardner_equal(got, want)
        assert hits + misses <= C * n_out
        assert hits >= 0.9 * C * n_out, (hits, misses)
    monkeypatch.setattr(gardner_cuda, "launch_plan", plan)


@pytest.mark.parametrize("sps", [2, 4])
def test_gardner_misses_give_the_plain_bits(card, monkeypatch, sps):
    """One candidate per symbol (only the expected strobe and subfilter):
    the walker misses often and computes those pairs itself; hits and
    misses both give the plain loop's bits. Under the full candidate set a
    waveform whose timing steps by half a sample mid-block gives them too
    (the loop follows the step a few subfilters per symbol, so the walker
    still takes most pairs from the helpers)."""
    from dvbs2rx_tpu_torch.ops import gardner_cuda

    sync, x, st, n_out = _gardner_case(card, "polyphase", sps, 2, 700)
    want = gardner_cuda.symbol_sync_plain(sync, st, x, n_out)
    plan = gardner_cuda.launch_plan
    monkeypatch.setattr(gardner_cuda, "launch_plan",
                        functools.partial(plan, n_cand=1))
    gardner_cuda.reset_speculation_counts()
    got = sync.step(st, x, n_out)
    hits, misses = gardner_cuda.speculation_counts()
    _assert_gardner_equal(got, want)
    assert misses > 0 and hits > 0, (hits, misses)
    monkeypatch.setattr(gardner_cuda, "launch_plan", plan)
    # a half-sample timing step in the middle of the block
    half = 350 * sps
    a = _gardner_waveform(700, sps, seed=31, frac_delay=0.0)
    b = _gardner_waveform(700, sps, seed=31, frac_delay=0.5)
    step = torch.from_numpy(np.concatenate([a[:half], b[half:]])[None]).to(
        card)
    st1 = sync.init_state(1)
    want = gardner_cuda.symbol_sync_plain(sync, st1, step, n_out)
    gardner_cuda.reset_speculation_counts()
    _assert_gardner_equal(sync.step(st1, step, n_out), want)
    hits, misses = gardner_cuda.speculation_counts()
    assert hits > 0.9 * n_out, (hits, misses)


def _clock_offset_waveform(n_syms, sps, offset, seed, noise=0.1, span=10):
    """(n, 2) float32: RRC-shaped QPSK (rolloff 0.2, +-span symbols) at
    sps * (1 + offset) samples per symbol, a sample-clock offset against
    the receiver's sps, with complex noise of std ``noise`` per rail."""
    from dvbs2rx_tpu_torch.ops.resample import rrc_continuous

    rng = np.random.default_rng(seed)
    s = (1 - 2 * rng.integers(0, 2, (n_syms, 2))) @ [1, 1j] / np.sqrt(2)
    T = sps * (1 + offset)
    t = np.arange(int((n_syms - 2 * span) * T)) / T + span   # in symbols
    k = np.floor(t).astype(int)[:, None] + np.arange(-span, span + 1)
    iq = (s[k] * rrc_continuous(t[:, None] - k, 0.2)).sum(1)
    iq = iq + noise * (rng.normal(size=iq.size)
                       + 1j * rng.normal(size=iq.size))
    return cplx.from_np(iq.astype(np.complex64))


@pytest.mark.parametrize("offset", [1e-3, -1e-3])
@pytest.mark.parametrize("sps", [2, 4])
def test_gardner_wrap_candidates_give_the_plain_bits(card, sps, offset):
    """A +-1000 ppm sample-clock offset makes mu wrap through 0/1 again and
    again, so strobes take jumps of sps - 1 and sps + 1: the candidates the
    helpers reach through the carry into the neighbouring jump. After 300
    symbols of lock, 900 symbols through the kernel: the plain loop's
    strobes (one symbol per call) take both neighbour jumps and follow the
    offset's sign, the walker takes every pair after the first from the
    helpers (no miss), and the bits are the plain loop's."""
    from dvbs2rx_tpu_torch.ops import gardner_cuda
    from dvbs2rx_tpu_torch.ops.frontend import SymbolSync

    kw = dict(loop_bw=0.005, damping=0.707) if sps == 4 else {}
    sync = SymbolSync(sps=sps, device=card, **kw)
    x = torch.from_numpy(_clock_offset_waveform(1300, sps, offset, 7)[None]
                         ).to(card)
    st, _ = gardner_cuda.symbol_sync_plain(sync, sync.init_state(1), x, 300)
    n_out = 900
    want = gardner_cuda.symbol_sync_plain(sync, st, x, n_out)
    jumps, s = [], st
    for _ in range(n_out - 1):
        s, _ = gardner_cuda.symbol_sync_plain(sync, s, x, 1)
        jumps.append(int(s.jump[0]))     # the jump to strobes 1 .. n_out-1
    assert {sps - 1, sps + 1} <= set(jumps) <= {sps - 1, sps, sps + 1}
    assert np.sign(sum(jumps) - (n_out - 1) * sps) == np.sign(offset)
    assert int(want[0].n[0]) == int(st.n[0] + st.jump[0]) + sum(jumps)
    gardner_cuda.reset_speculation_counts()
    got = sync.step(st, x, n_out)
    hits, misses = gardner_cuda.speculation_counts()
    _assert_gardner_equal(got, want)
    assert (hits, misses) == (n_out - 1, 0), (hits, misses)


def test_gardner_on_card_never_runs_the_plain_loop(card, monkeypatch):
    from dvbs2rx_tpu_torch.ops import gardner_cuda

    def refuse(*a, **k):
        raise AssertionError("the plain loop ran on a CUDA tensor")

    monkeypatch.setattr(gardner_cuda, "symbol_sync_plain", refuse)
    for method in ("polyphase", "linear", "quadratic", "cubic"):
        sync, x, st, n_out = _gardner_case(card, method, 2, 2, 300)
        before = gardner_cuda.LAUNCHES
        _, sym = sync.step(st, x, n_out)
        assert gardner_cuda.LAUNCHES == before + 1
        assert sym.is_cuda and bool(torch.isfinite(sym).all())


# (d) short: 5 short QPSK 1/2 frames delayed by 0.4 sample at 9 dB. Both
# receivers, JAX's and the port's, give the first 13 packets sent on this
# IQ (tests/test_torch_gardner_rx.py holds them to it): no frame goes to
# acquisition, and the stream's last two frames are not decoded, with ffw
# timing too (the tail of the stream, not the Gardner loop).
GARDNER_CCM_RX = dict(modcod="qpsk1/2", frame_size="short", fec_batch=4,
                      sym_sync_impl="gardner")
GARDNER_CCM_PACKETS = 13


def gardner_ccm_iq():
    """(iq, packets) of the (d)-short stimulus."""
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(5)
    pkts = rng.integers(0, 256, (5 * tx.df_bytes // 188, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    clean = tx.ts_to_iq(pkts.reshape(-1))
    iq = awgn_channel((clean[1:] * 0.6 + clean[:-1] * 0.4).astype(
        np.complex64), 9.0, sps=2, seed=6)
    return iq, pkts


def test_gardner_receiver_on_card_matches_cpu(card):
    """(d) short: ``Receiver`` with Gardner timing on short QPSK 1/2 with a
    fractional timing offset: TS bytes and counters equal on the card and
    on the CPU, the first GARDNER_CCM_PACKETS packets sent as JAX gives
    them, one Gardner launch per front-end block."""
    from dvbs2rx_tpu_torch.ops import gardner_cuda
    from dvbs2rx_tpu_torch.rx.receiver import make_receiver

    iq, pkts = gardner_ccm_iq()
    cfg = RxConfig(**GARDNER_CCM_RX)
    launches, blocks = {}, {}

    def run(rx):
        before = gardner_cuda.LAUNCHES
        orig = rx._call
        n = blocks[rx.device.type] = [0]

        def call(key, fn, args):
            n[0] += key[0] == "fe"
            return orig(key, fn, args)

        rx._call = call
        out = rx.receive(iq)
        launches[rx.device.type] = gardner_cuda.LAUNCHES - before
        return out

    g, c, ts_g, ts_c = _host_pair(lambda d: make_receiver(cfg, device=d),
                                  run)
    np.testing.assert_array_equal(ts_g, ts_c)
    _assert_host_same(g, c)
    assert c.stats.locked and c.stats.bch_frame_errors == 0
    np.testing.assert_array_equal(ts_c.reshape(-1, 188),
                                  pkts[:GARDNER_CCM_PACKETS])
    assert launches["cpu"] == 0 and blocks["cuda"][0] >= 5
    assert launches["cuda"] == blocks["cuda"][0]


def test_gardner_batched_acm_on_card_matches_cpu(card):
    """(g) short: ``BatchedACMReceiver`` with Gardner timing, 2 channels:
    each channel's TS bytes and counters equal on the card and on the CPU,
    every front-end group one launch for both channels."""
    from dvbs2rx_tpu_torch.ops import gardner_cuda
    from dvbs2rx_tpu_torch.rx.acm_batch import BatchedACMReceiver

    _, iq = _vcm_case([0, -1, 1], 60)
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", pilots=True,
                   acm_vcm=True, fec_batch=4, sym_sync_impl="gardner")
    launches = {}

    def run(brx):
        before = gardner_cuda.LAUNCHES
        out = brx.receive(iq)
        launches[brx.device.type] = gardner_cuda.LAUNCHES - before
        return out

    g, c, ts_g, ts_c = _host_pair(
        lambda d: BatchedACMReceiver(cfg, 2, device=d), run)
    for ch in range(2):
        np.testing.assert_array_equal(ts_g[ch], ts_c[ch])
        _assert_host_same(g.chans[ch], c.chans[ch])
        assert ts_c[ch].size >= 188 * 10
    assert launches["cpu"] == 0
    assert 0 < launches["cuda"] <= iq.shape[1] // (2 * 4096) + 3


def _pipeline_symbols(cfg, C, F, std, seed):
    tx = Transmitter(TxConfig(modcod=cfg.modcod, frame_size=cfg.frame_size,
                              pilots=cfg.pilots))
    L = cfg.pls_info.plframe_len
    rng = np.random.default_rng(seed)
    n_pkts = ((F + 2) * tx.df_bytes) // 188 + 2
    pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    syms = tx.modulate_ts(pkts.reshape(-1))[: (F + 1) * L + 91]
    noise = rng.normal(0, std, (C, syms.size, 2))
    return (syms[None] + noise[..., 0] + 1j * noise[..., 1]).astype(
        np.complex64)


@pytest.mark.parametrize("modcod,pilots,std", [("qpsk1/2", False, 0.45),
                                               ("8psk3/5", True, 0.2)])
def test_batched_pipeline_on_card_matches_cpu(card, modcod, pilots, std):
    """``BatchedPipeline`` on the card against the CPU: kbytes,
    ``bch_errors`` and ``ldpc_iters`` equal, n0 and ``metric_min`` within
    rtol 1e-4; one LDPC launch per step."""
    from dvbs2rx_tpu_torch.parallel.batch import BatchedPipeline

    cfg = RxConfig(modcod=modcod, frame_size="short", pilots=pilots)
    C, F = 8, 2
    syms = _pipeline_symbols(cfg, C, F, std, seed=12)
    out = {}
    for dev in ("cpu", card):
        pipe = BatchedPipeline(cfg, C, F, device=dev)
        h, p = pipe.frame_inputs_from_symbols(syms)
        before = ldpc_cuda.LAUNCHES
        kb, n0, st = pipe.step(h, p, True)
        out[str(dev)] = (kb.cpu().numpy(), n0.cpu().numpy(),
                         {k: v.item() for k, v in st.items()},
                         ldpc_cuda.LAUNCHES - before)
    (kb_c, n0_c, st_c, n_c), (kb_g, n0_g, st_g, n_g) = out.values()
    np.testing.assert_array_equal(kb_g, kb_c)
    assert st_g["bch_errors"] == st_c["bch_errors"] == 0
    assert st_g["ldpc_iters"] == st_c["ldpc_iters"]
    np.testing.assert_allclose(n0_g, n0_c, rtol=1e-4)
    np.testing.assert_allclose(st_g["metric_min"], st_c["metric_min"],
                               rtol=1e-4)
    assert (n_c, n_g) == (0, 1)


@pytest.mark.parametrize("frame_size,rate", [("normal", "1/2"),
                                             ("short", "3/5")])
def test_device_encoder_on_card_matches_host_with_tf32_on(card, frame_size,
                                                          rate):
    from dvbs2rx_tpu_torch.ops.encode import get_device_encoder
    from dvbs2rx_tpu_torch.spec.fec_params import get_fec_info

    fec = get_fec_info(frame_size, rate)
    code = get_code(fec.ldpc_table)
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, 2, (128, fec.kbch)).astype(np.uint8)
    msgs[0] = 1
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cw = get_device_encoder(frame_size, rate, device=card)(
            torch.from_numpy(msgs.T.copy()).to(card)).cpu().numpy().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    bch = np.stack([np.concatenate([m, np.unpackbits(
        bch_spec.bch_encode_bytes(np.packbits(m), frame_size, fec.t))])
        for m in msgs])
    np.testing.assert_array_equal(cw, code.encode(bch))


def test_rx_app_loopback_on_the_card(card, tmp_path, capsys):
    """Tx app -> rx app with the default ``--device cuda``: a consecutive
    bit-exact TS, 0 BCH errors, both kernels of the CCM stream launched."""
    import json

    from chip_smoke import _assert_consecutive
    from dvbs2rx_tpu_torch.apps import dvbs2_rx, dvbs2_tx

    rng = np.random.default_rng(14)
    pkts = rng.integers(0, 256, (80, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    pkts.tofile(tmp_path / "in.ts")
    short = ["--modcod", "qpsk1/2", "--frame-size", "short"]
    assert dvbs2_tx.main(["--in-file", str(tmp_path / "in.ts"), "--out-file",
                          str(tmp_path / "iq"), *short, "--snr", "12"]) == 0
    capsys.readouterr()
    before = dvbs2_rx.kernel_launches()
    assert dvbs2_rx.main(["--in-file", str(tmp_path / "iq"), "--out-file",
                          str(tmp_path / "out.ts"), *short]) == 0
    after = dvbs2_rx.kernel_launches()
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["locked"] and stats["bch_frame_errors"] == 0
    _assert_consecutive(np.fromfile(tmp_path / "out.ts", np.uint8), pkts, 55)
    assert after["mf_segmented"] > before["mf_segmented"]
    assert after["ldpc_layered"] > before["ldpc_layered"]


# ------------------------------------------------ scan step and the meshes

def _scan_case(dev, C=2, T=3, seed=3):
    """A primed short-frame StreamReceiver on ``dev`` with T blocks of its
    stimulus (15 dB) on the card."""
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short")
    sr = StreamReceiver(cfg, n_channels=C, frames_per_step=2, device=dev)
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (260, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq1 = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 15.0, sps=2, seed=seed)
    iq = np.stack([iq1] * C)
    blocks = torch.as_tensor(np.stack([
        cplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                        sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
        for t in range(T)]), device="cuda")
    return cfg, sr, iq[:, : sr._n_fe], blocks


def _eager(sr, state, blocks):
    out = []
    for t in range(blocks.shape[0]):
        state, kb, stats = sr.step(state, blocks[t])
        out.append((kb, stats))
    return state, out


def _assert_like_eager(got, want):
    """Stats stacked over the steps against the eager steps'; the LDPC
    counters a scan call sums (``CALL_SUMS``) against the steps' sum."""
    _, kbs, stats = got
    for k in CALL_SUMS:
        g = stats[k].cpu()
        if g.dim():                 # the eager steps, stacked by the caller
            g = g.sum()
        assert int(g) == sum(int(st[k]) for _, st in want), k
    for t, (kb, st) in enumerate(want):
        assert torch.equal(kbs[t], kb.to(kbs.device))
        for k, v in st.items():
            if k in CALL_SUMS:
                continue
            g, v = stats[k][t].cpu(), v.cpu()
            if v.dtype.is_floating_point:
                torch.testing.assert_close(g, v, rtol=1e-6, atol=1e-12,
                                           msg=k)
            else:
                assert torch.equal(g, v), k


def test_scan_graph_records_the_kernels_and_equals_eager_steps(card):
    """One capture of T = 3 chained steps holds T launches of each ctypes
    kernel of the step (the front end's AGC, rotate and tracker kernels,
    MF, PLHEADER, payload, LDPC, the sync-free form's BCH locator, Chien
    and CRC-8, and the SNR refinement; counted while captured; the profiler
    sees them in one replay), and its replays equal T eager steps from the
    same state, call after call, with no host sync."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    _, sr, prefix, blocks = _scan_case(card)
    primed = sr.prime(prefix)
    _, want = _eager(sr, primed, blocks)
    scan = sr.make_scan_step(3)
    before = launch_counts()
    out = scan(primed, blocks)
    step_kernels = ("mf_segmented", "plsync_header", "plsync_stats",
                    "plsync_demap", "ldpc_layered", "bch_locator", "bch_chien",
                    "crc8_validity", "frontend_agc", "frontend_rotate",
                    "ffsync_track", "snr_refine")
    assert scan.launches_per_call == {
        k: 3 if k in step_kernels else 0 for k in before}
    # the warm-up step and the capture
    captured = {k: n - before[k] for k, n in launch_counts().items()}
    assert all(captured[k] == 4 for k in step_kernels), captured
    _assert_like_eager(out, want)
    state_buf = out[0]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again = scan(primed, blocks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    assert again[0] is state_buf            # the graph's own buffers
    _assert_like_eager(again, want)
    # a replay runs no Python
    assert {k: n - before[k] for k, n in launch_counts().items()} == captured
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan(primed, blocks)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    counts = {k: sum(e.count for e in prof.key_averages()
                     if k + "_kernel" in e.key)
              for k in step_kernels}
    assert counts == dict.fromkeys(step_kernels, 3), names


def test_scan_chains_its_own_state(card):
    """Feeding a call the state the last call returned copies nothing and
    continues the stream: two calls of T = 2 equal four eager steps."""
    _, sr, prefix, blocks = _scan_case(card, T=4, seed=5)
    primed = sr.prime(prefix)
    _, want = _eager(sr, primed, blocks)
    scan = sr.make_scan_step(2)
    state, kbs, stats = scan(primed, blocks[:2])
    _assert_like_eager((state, kbs, stats), want[:2])
    _assert_like_eager(scan(state, blocks[2:]), want[2:])


def test_a_capture_that_cannot_complete_raises(card, monkeypatch):
    """A step that reads back to the host inside the capture (here the
    branching BCH) makes the capture fail, and the scan raises: it never
    falls back to eager steps."""
    from dvbs2rx_tpu_torch.rx import stream

    def branching_chain(sr, state, blocks):
        for t in range(blocks.shape[0]):
            state, kb, st = sr._step(state, blocks[t], sync_free=False)
        return state, kb[None], {k: v[None] for k, v in st.items()}

    _, sr, prefix, blocks = _scan_case(card, T=2, seed=6)
    monkeypatch.setattr(stream, "_chain", branching_chain)
    with pytest.raises(RuntimeError):
        sr.make_scan_step(2)(sr.prime(prefix), blocks)
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_of_one_card_repeated_equals_one_card(card, D):
    """A channel mesh of cuda:0 repeated D times: steps and a scan call
    equal the unsharded receiver's eager steps; BatchedPipeline(mesh=)
    equals the unsharded pipeline."""
    from dvbs2rx_tpu_torch.parallel.batch import (
        BatchedPipeline,
        make_channel_mesh,
    )

    cfg, sr, prefix, blocks = _scan_case(card, C=4, T=2, seed=7)
    _, want = _eager(sr, sr.prime(prefix), blocks)
    mesh = make_channel_mesh(["cuda:0"] * D)
    msr = StreamReceiver(cfg, n_channels=4, frames_per_step=2, mesh=mesh)
    st = msr.prime(prefix)
    got = []
    for t in range(2):
        st, kb, stats = msr.step(st, blocks[t])
        got.append((kb, stats))
    _assert_like_eager((None, torch.stack([g[0] for g in got]),
                        {k: torch.stack([g[1][k] for g in got])
                         for k in got[0][1]}), want)
    _assert_like_eager(msr.make_scan_step(2)(msr.prime(prefix), blocks),
                       want)
    syms = _pipeline_symbols(cfg, 8, 2, 0.3, seed=8)
    plain = BatchedPipeline(cfg, 8, 2, device=card)
    h, p = plain.frame_inputs_from_symbols(syms)
    kb0, n00, st0 = plain.step(h, p, True)
    kb1, n01, st1 = BatchedPipeline(cfg, 8, 2, mesh=mesh).step(h, p, True)
    assert torch.equal(kb1, kb0)
    torch.testing.assert_close(n01, n00, rtol=1e-6, atol=0)
    assert int(st1["bch_errors"]) == 0 and int(st1["ldpc_iters"]) == \
        int(st0["ldpc_iters"])


def test_mesh_of_two_cards_equals_one_card(card):
    """A channel mesh of two distinct cards against one card. It skips on
    a machine with one card, where the multi-card path runs only as
    cuda:0 repeated."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from dvbs2rx_tpu_torch.parallel.batch import make_channel_mesh

    cfg, sr, prefix, blocks = _scan_case(card, C=4, T=2, seed=9)
    _, want = _eager(sr, sr.prime(prefix), blocks)
    mesh = make_channel_mesh(["cuda:0", "cuda:1"])
    msr = StreamReceiver(cfg, n_channels=4, frames_per_step=2, mesh=mesh)
    _assert_like_eager(msr.make_scan_step(2)(msr.prime(prefix), blocks),
                       want)
    st = msr.prime(prefix)
    assert st[1]["sbuf"].device == torch.device("cuda", 1)
    for t in range(2):
        st, kb, stats = msr.step(st, blocks[t])
        assert torch.equal(kb, want[t][0])


# ---- the FEC tail kernels (BCH locator, Chien, CRC-8)


def _fec_tail_bits(card, frame_size, rate, B, seed, clean=False):
    """(nbch, B) lane-major codewords from the port's encoder with frame b
    carrying (b + 7) mod (2t + 4) errors where B <= 2, else b mod (2t + 4)
    (every third frame's in the parity bits), or none; the decoder and the
    errors per frame."""
    enc = get_device_encoder(frame_size, rate, card)
    fec = enc.fec
    rng = np.random.default_rng(seed)
    msg = torch.as_tensor(rng.integers(0, 2, (fec.kbch, B), dtype=np.uint8),
                          device=card)
    first = 7 if B <= 2 else 0
    n_err = (np.zeros(B, np.int64) if clean
             else (np.arange(B) + first) % (2 * fec.t + 4))
    flips = np.zeros((fec.nbch, B), np.uint8)
    for b, k in enumerate(n_err):
        lo = fec.kbch if b % 3 == 1 else 0
        flips[lo + rng.choice(fec.nbch - lo, int(k), replace=False), b] = 1
    bits_t = enc.bch_encode_lane_major(msg) ^ torch.as_tensor(flips,
                                                              device=card)
    dec = BCHDecoder(frame_size, fec.t, fec.nbch, fec.kbch, card)
    return dec, bits_t, n_err


def _captured(fn):
    """fn() captured as a CUDA graph (a warm-up call on a side stream
    first) and replayed once: the graph's outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("layout", ["lane-major", "rows", "rows-slice"])
@pytest.mark.parametrize("B", [1, 2, 8, 37, 48, 128, 256])
def test_locator_kernel_matches_plain(card, B, layout):
    """The locator kernel's S, sigma and L equal locator_plain's on S2_B4
    codewords with errors (uncorrectable frames included) and on a clean
    batch, in either layout (and rows cut from wider rows at an odd
    offset), eagerly and replayed from a captured graph, call after call
    (its scratch returns to zero). B = 48 stages a half-empty last group
    by 16-byte copies, 256 takes eight groups."""
    for clean in (False, True):
        dec, bits_t, _ = _fec_tail_bits(card, "normal", "1/2", B, 40 + B,
                                        clean)
        if layout == "lane-major":
            bits = bits_t.t()
        elif layout == "rows":
            bits = bits_t.t().contiguous()
        else:
            wide = torch.zeros((B, dec.nbch + 40), dtype=torch.uint8,
                               device=card)
            wide[:, 13: 13 + dec.nbch] = bits_t.t()
            bits = wide[:, 13: 13 + dec.nbch]
        args = (dec._odd, dec._exp16, dec._log16, dec._zech16,
                bch_cuda.new_scratch(B, dec.t, card), dec.t, dec.nbch,
                dec.ord)
        want = bch.locator_plain(bits, dec.syndrome_matrix(), dec._exp,
                                 dec._log, dec.t, dec.ord)
        before = bch_cuda.LAUNCHES["bch_locator"]
        for _ in range(2):
            got = bch_cuda.locator(bits, *args)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert bch_cuda.LAUNCHES["bch_locator"] == before + 2
        got = _captured(lambda: bch_cuda.locator(bits, *args))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert bool((want[0] == 0).all()) == clean


@pytest.mark.parametrize("frame_size,rate,B", [
    ("short", "1/2", 32), ("normal", "1/2", 28), ("normal", "2/3", 24),
    ("normal", "8/9", 20)])
def test_bch_kernels_match_plain(card, frame_size, rate, B):
    """The locator's S, sigma and L, the corrected bits and n_corr of the
    kernels equal the plain versions' on 0, 1..t and t+1..2t+3 errors, in
    both forms and both layouts, and in a captured graph of the sync-free
    form; an all-clean batch in the default form launches the locator
    only."""
    dec, bits_t, n_err = _fec_tail_bits(card, frame_size, rate, B, 20 + B)
    bits = bits_t.t()
    before = dict(bch_cuda.LAUNCHES)
    loc_k = dec.locator(bits)
    got = []
    for sync_free in (False, True):
        got_t, n = dec.decode_lane_major(bits_t, sync_free)
        got.append((got_t.t(), n))
        got.append(dec(bits_t.t().contiguous(), sync_free))
    assert {k: v - before[k] for k, v in bch_cuda.LAUNCHES.items()} == {
        "bch_locator": 5, "bch_chien": 4}
    assert dec._A_mat is None and dec._T is None  # the kernels need neither
    want_loc = bch.locator_plain(bits, dec.syndrome_matrix(), dec._exp,
                                 dec._log, dec.t, dec.ord)
    assert all(torch.equal(g, w) for g, w in zip(loc_k, want_loc))
    want = bch.correct_plain(bits, *want_loc, dec.chien_matrix(), dec.t)
    np.testing.assert_array_equal(want[1].cpu().numpy(),
                                  np.where(n_err <= dec.t, n_err, -1))
    for c, n in got:
        assert torch.equal(c, want[0]) and torch.equal(n, want[1])
    out_t, out_n = _captured(lambda: dec.decode_lane_major(bits_t, True))
    assert torch.equal(out_t.t(), want[0]) and torch.equal(out_n, want[1])
    dec2, clean_t, _ = _fec_tail_bits(card, frame_size, rate, B, 1, True)
    before = dict(bch_cuda.LAUNCHES)
    got_t, n = dec2.decode_lane_major(clean_t)
    assert got_t.data_ptr() == clean_t.data_ptr() and not n.any()
    assert {k: v - before[k] for k, v in bch_cuda.LAUNCHES.items()} == {
        "bch_locator": 1, "bch_chien": 0}
    got_t, n = dec2.decode_lane_major(clean_t, True)
    assert torch.equal(got_t, clean_t) and not n.any()


def test_card_decoder_builds_neither_a_nor_t(card):
    """A decoder on the card holds no syndrome matrix A and no Chien matrix
    T after its entry points, in either form, clean or not: the card's
    memory grows by less than 2 MB (the kernels' tables are built with the
    decoder; A alone is 49.8 MB at S2_B4, T 431 MB)."""
    dec, bits_t, _ = _fec_tail_bits(card, "normal", "1/2", 128, 9)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    for sync_free in (False, True):
        out = dec.decode_lane_major(bits_t, sync_free)
        out = dec(bits_t.t().contiguous(), sync_free)
    del out
    torch.cuda.synchronize()
    assert dec._A_mat is None and dec._T is None
    assert torch.cuda.memory_allocated() - m0 < 2 << 20


def test_fec_tail_wrappers_raise_on_what_the_kernels_do_not_take(card):
    dec, bits_t, _ = _fec_tail_bits(card, "short", "1/2", 4, 3)
    bits = bits_t.t()
    loc = (dec._odd, dec._exp16, dec._log16, dec._zech16,
           bch_cuda.new_scratch(4, dec.t, card), dec.t, dec.nbch, dec.ord)
    chien = (dec._exp16, dec._log, dec.t, dec.nbch, dec.ord)
    S, sig, L = bch_cuda.locator(bits, *loc)
    with pytest.raises(ValueError):
        bch_cuda.locator(bits.to(torch.int32), *loc)
    with pytest.raises(ValueError):
        bch_cuda.locator(bits[:, :-1], *loc)
    with pytest.raises(ValueError):                 # tables on the CPU
        bch_cuda.locator(bits, dec._odd.cpu(), *loc[1:])
    with pytest.raises(ValueError):
        bch_cuda.locator(bits, *loc[:3], dec._zech16.cpu(), *loc[4:])
    with pytest.raises(ValueError):         # another batch size's scratch
        bch_cuda.locator(bits, *loc[:4],
                         bch_cuda.new_scratch(40, dec.t, card), *loc[5:])
    with pytest.raises(ValueError):                 # not a DVB-S2 code
        bch_cuda.locator(bits, *loc[:5], 11, *loc[6:])
    with pytest.raises(ValueError):
        bch_cuda.chien_correct(bits.to(torch.int32), S, sig, L, *chien)
    with pytest.raises(ValueError):
        bch_cuda.chien_correct(bits[:, :-1], S, sig, L, *chien)
    with pytest.raises(ValueError):
        bch_cuda.chien_correct(bits, S.cpu(), sig, L, *chien)
    with pytest.raises(ValueError):
        bch_cuda.chien_correct(bits, S, sig, L, dec._exp16.cpu(), *chien[1:])
    with pytest.raises(ValueError):
        bch_cuda.chien_correct(bits, S.t().contiguous().t(), sig, L, *chien)
    frames = torch.zeros((3, 879), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):
        crc8_cuda.crc8_validity(frames.to(torch.int32))
    with pytest.raises(ValueError):
        crc8_cuda.crc8_validity(frames[None])
    with pytest.raises(ValueError):
        crc8_cuda.crc8_validity(frames[:, :9])
    with pytest.raises(ValueError):
        crc8_cuda.crc8_validity(
            torch.zeros((2, crc8_cuda.MAX_N + 1), dtype=torch.uint8,
                        device=card))
    with pytest.raises(ValueError):
        crc8_cuda.crc8_validity(frames.t().contiguous().t())


def _crc8_frames(B, n, window, rng):
    """B rows of n random bytes: row 0 all zeros, row 1 a zero prefix of
    300 bytes, row 2 (B > 2) packets of ``window`` bytes each followed by
    its CRC-8, so that most of its windows are valid."""
    from dvbs2rx_tpu_torch.spec.scramblers import crc8_table

    frames = rng.integers(0, 256, (B, n), dtype=np.uint8)
    frames[0] = 0
    if B > 1:
        frames[1, :300] = 0
    if B > 2:
        T = crc8_table()
        for p in range(window, n, window + 1):
            rem = 0
            for v in frames[2, p - window:p]:
                rem = int(T[rem ^ int(v)])
            frames[2, p] = rem
    return frames


@pytest.mark.parametrize("window", [1, 187, 255])
@pytest.mark.parametrize("B", [1, 2, 37, 128])
@pytest.mark.parametrize("n", [879, 883, 4026, 4836, 7274])
def test_crc8_kernel_matches_plain(card, n, B, window):
    """Random bytes at n (no n is a multiple of 8, so every row has pad
    bits), a row of zeros, a zero-prefixed row, a row of valid windows,
    and at window 187 Tx BBFRAMEs of the code whose frames have n bytes."""
    rng = np.random.default_rng(n * 1000 + B + window)
    x = torch.from_numpy(_crc8_frames(B, n, window, rng)).to(card)
    before = crc8_cuda.LAUNCHES
    got = packet_validity(x, window)
    assert crc8_cuda.LAUNCHES == before + 1
    want = packet_validity_plain(x, window)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if window != 187:
        return
    for modcod, fs in (("qpsk1/2", "normal"), ("8psk3/5", "normal"),
                       ("qpsk1/2", "short")):
        tx = Transmitter(TxConfig(modcod=modcod, frame_size=fs))
        if tx.kbch_bytes != n:
            continue
        pkts = rng.integers(0, 256, (B * tx.df_bytes // 188 + 2, 188),
                            dtype=np.uint8)
        pkts[:, 0] = 0x47
        tx_frames = torch.from_numpy(np.ascontiguousarray(
            tx.bbframes(pkts.reshape(-1))[:B] ^ tx.bb_scramble)).to(card)
        got = packet_validity(tx_frames)
        want = packet_validity_plain(tx_frames)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(want[1].all())


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_crc8_kernel_misaligned_rows_and_graph(card, offset):
    """Rows that start at an odd byte offset of their allocation (a
    contiguous view into a larger buffer, so no row is 16-byte aligned):
    the kernel equals the plain version eagerly and in a captured CUDA
    graph, replayed on new bytes copied into the captured input."""
    rng = np.random.default_rng(offset)
    B, n = 37, 4026
    buf = torch.zeros(B * n + 64, dtype=torch.uint8, device=card)
    x = buf[offset:offset + B * n].view(B, n)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset
    x.copy_(torch.from_numpy(_crc8_frames(B, n, 187, rng)))
    got = packet_validity(x)
    want = packet_validity_plain(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        packet_validity(x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = crc8_cuda.LAUNCHES
    with torch.cuda.graph(g):
        out = packet_validity(x)
    assert crc8_cuda.LAUNCHES == before + 1
    for seed in (1, 2):
        x.copy_(torch.from_numpy(_crc8_frames(
            B, n, 187, np.random.default_rng(100 * offset + seed))))
        g.replay()
        want = packet_validity_plain(x)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert crc8_cuda.LAUNCHES == before + 1


def test_scan_step_counts_the_fec_tail_kernels_at_capture(card):
    """make_scan_step(2) at a small width: the graph holds two launches of
    each FEC tail kernel (counted at capture, the profiler sees them in one
    replay), and a call equals two eager steps."""
    from torch.profiler import ProfilerActivity, profile

    _, sr, prefix, blocks = _scan_case(card, C=2, T=2, seed=10)
    primed = sr.prime(prefix)
    _, want = _eager(sr, primed, blocks)
    scan = sr.make_scan_step(2)
    _assert_like_eager(scan(primed, blocks), want)
    fec_tail = ("bch_locator", "bch_chien", "crc8_validity")
    assert {k: scan.launches_per_call[k] for k in fec_tail} == \
        dict.fromkeys(fec_tail, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan(primed, blocks)
        torch.cuda.synchronize()
    counts = {k: sum(e.count for e in prof.key_averages()
                     if k + "_kernel" in e.key) for k in fec_tail}
    assert counts == dict.fromkeys(fec_tail, 2)


def test_ffsync_single_stream_step_on_card_matches_cpu(card):
    from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync

    n_out = 8192
    n = 2 * n_out + FeedForwardSync(sps=2, device="cpu").history()
    x = np.random.default_rng(13).normal(size=(n, 2)).astype(np.float32)
    outs = []
    for dev in ("cpu", card):
        sync = FeedForwardSync(sps=2, device=dev)
        st, syms, cons = sync.step(sync.init_state(), x, n_out)
        assert st.tau.shape == () and syms.shape == (n_out, 2)
        outs.append((syms.cpu().numpy(), int(cons), float(st.tau)))
    (s0, c0, t0), (s1, c1, t1) = outs
    assert c0 == c1
    np.testing.assert_allclose(s1, s0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t1, t0, rtol=1e-4)


def test_bench_sections_on_card_at_a_small_width(card):
    from dvbs2rx_tpu_torch import bench

    before = launch_counts()
    fe = bench.measure_frontend(2, device="cuda")
    gf = bench.measure_group_fec(2, 2, device="cuda", frame_size="short")
    after = launch_counts()
    assert fe["frontend_ok"] and gf["group_fec_ok"], (fe, gf)
    assert gf["bch_frame_errors"] == 0 and gf["post_fec_ber"] == 0.0
    assert fe["frontend_launches_per_step"]["mf_segmented"] == 1
    assert gf["group_fec_launches_per_step"]["ldpc_layered"] == 1
    assert after["mf_segmented"] > before["mf_segmented"]
    assert isinstance(gf["group_fec_host_syncs_per_step"], int)


# ------------- PL sync + demap kernels (csrc/plsync.cu, ops/plsync_cuda) -----

@pytest.mark.parametrize("pilots", [False, True])
@pytest.mark.parametrize("modcod", ["qpsk1/2", "8psk3/5", "16apsk2/3",
                                    "32apsk3/4"])
def test_plsync_kernels_match_plain(card, modcod, pilots):
    """The PLHEADER and payload kernels against their plain versions on
    chip_smoke phase 14 (c)'s inputs (4 channels x 2 short frames): phases,
    metric, autocorrelation, fine, N0 and symbols within its tolerances,
    int8 LLRs equal but for +-1 at rounding ties; per-lane starts clamping
    at both ends, a lane mask and the row layout with padding."""
    from dvbs2rx_tpu_torch.ops import plsync_cuda

    n0 = dict(plsync_cuda.LAUNCHES)
    rec = _plsync_small(card.type, [(modcod, pilots)])
    assert plsync_cuda.LAUNCHES["plsync_header"] == n0["plsync_header"] + 1
    for k in ("plsync_stats", "plsync_demap"):
        assert plsync_cuda.LAUNCHES[k] == n0[k] + 2
    (r,) = rec.values()
    assert r["payload"]["llr_ties"] <= 1e-3 * r["payload"]["llrs"]


@pytest.mark.parametrize("full", [True, False])
def test_coarse_autocorr_kernel_matches_plain(card, full):
    """coarse_autocorr on the card: one PLHEADER launch for any batch
    shape (a non-contiguous view, an int32 PLS broadcast over a channel
    axis), recorded under its layout, within 1e-5 of the largest magnitude
    of its plain version."""
    from dvbs2rx_tpu_torch.ops import plsync, plsync_cuda

    rng = np.random.default_rng(31 + full)
    hdr = torch.as_tensor(rng.standard_normal((7, 5, 90, 2)).astype(
        np.float32), device=card).transpose(0, 1)          # (5, 7, 90, 2)
    pls = torch.as_tensor(rng.integers(0, 128, (1, 7)).astype(np.int32),
                          device=card)
    n0 = plsync_cuda.LAUNCHES["plsync_header"]
    before = dict(plsync_cuda.LAUNCH_SHAPES)
    got = plsync.coarse_autocorr(hdr, pls, full=full)
    assert plsync_cuda.LAUNCHES["plsync_header"] == n0 + 1
    layout = plsync_cuda._header_layout([hdr.reshape(1, 35, 90, 2)], 35,
                                        90 if full else 26, False)
    assert {k: n - before.get(k, 0) for k, n in
            plsync_cuda.LAUNCH_SHAPES.items() if n != before.get(k, 0)} \
        == {layout: 1}
    want = plsync.coarse_autocorr_plain(hdr, pls, full=full)
    assert got.shape == want.shape == (5, 7, 89 if full else 25, 2)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


def test_plsync_wrappers_raise_on_the_card(card):
    """The wrappers refuse inputs the kernels do not take (a PLS on another
    device, a header view of another length, a float LLR buffer) and
    launch nothing then."""
    from dvbs2rx_tpu_torch.ops import plsync_cuda
    from dvbs2rx_tpu_torch.spec.pls import parse_pls

    hdr = torch.zeros((2, 3, 90, 2), device=card)
    pls = torch.zeros((6,), dtype=torch.int64, device=card)
    n0 = dict(plsync_cuda.LAUNCHES)
    for bad in ((hdr, pls.cpu()), (hdr[:, :, :89], pls),
                (hdr, pls.to(torch.int32))):
        with pytest.raises(ValueError):
            plsync_cuda.plheader([bad[0]], [bad[1]])
    info = parse_pls(4 << 2)
    B, Lp = 6, info.payload_len
    kw = dict(sym=torch.zeros((2, 3, Lp, 2), device=card), start=None,
              clamp_len=Lp, descr=torch.zeros((Lp, 2), device=card),
              ph=torch.zeros((B, 2, 2), device=card),
              cc=torch.zeros(B, dtype=torch.bool, device=card),
              n0_ov=torch.zeros(B, device=card), info=info,
              constellation="QPSK", rate="1/2",
              fine_out=torch.zeros(B, device=card),
              n0_out=torch.zeros(B, device=card))
    N = info.n_slots * 90 * 2
    with pytest.raises(ValueError):
        plsync_cuda.payload(llr_out=torch.zeros((N, B), device=card), **kw)
    with pytest.raises(ValueError):
        plsync_cuda.payload(llr_out=torch.zeros((N, B), dtype=torch.int8,
                                                device=card),
                            **dict(kw, constellation="8PSK", rate="3/5"))
    assert plsync_cuda.LAUNCHES == n0


def test_steps_on_card_never_run_the_plain_lane_program(card, monkeypatch):
    """A CCM step and a VCM step on the card go through the PLHEADER,
    statistics and demap kernels (one each a CCM step; 1 + 2 S a VCM
    step) and never through their plain versions (patched to raise)."""
    from dvbs2rx_tpu_torch.ops import plsync, plsync_cuda
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    def plain(*args, **kw):
        raise AssertionError("a plain lane function ran on the card")

    for mod, name in ((plsync_cuda, "payload_plain"),
                      (plsync_cuda, "plheader_plain"),
                      (plsync, "coarse_autocorr_plain")):
        monkeypatch.setattr(mod, name, plain)
    C, F, T = 2, 2, 2
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short")
    sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F, device=card)
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (120, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = np.stack([awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 15.0, sps=2,
                                seed=1)] * C)
    state = sr.prime(iq[:, : sr._n_fe])
    n0 = dict(plsync_cuda.LAUNCHES)
    for t in range(T):
        blk = cplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                              sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
        state, _, st = sr.step(state, sr.put_iq(blk))
    assert bool(st["locked"].all()) and int(st["bch_errors"]) == 0
    assert plsync_cuda.LAUNCHES["plsync_header"] == n0["plsync_header"] + T
    for k in ("plsync_stats", "plsync_demap"):
        assert plsync_cuda.LAUNCHES[k] == n0[k] + T
    vcfg, viq = _vcm_case([0, 1], 300)
    vr = VCMStreamReceiver(vcfg, 2, 2, fec_lanes=8, device=card)
    state = vr.prime(viq[:, : vr._n_fe])
    n0 = dict(plsync_cuda.LAUNCHES)
    for t in range(T):
        blk = cplx.from_np(viq[:, vr._n_fe + t * vr.n_in:
                               vr._n_fe + (t + 1) * vr.n_in]
                           ).astype(np.float32)
        state, _, st = vr.step(state, vr.put_iq(blk))
    assert int(st["n_walked"].sum()) > 0
    assert plsync_cuda.LAUNCHES["plsync_header"] == n0["plsync_header"] + T
    for k in ("plsync_stats", "plsync_demap"):
        assert plsync_cuda.LAUNCHES[k] == n0[k] + T * vr.S


def _lane_symbols(rng, n_mod, shape):
    """Seeded noisy symbols of a 2^n_mod-PSK grid, float32 (..., 2)."""
    m = 1 << n_mod
    ang = 2 * np.pi * rng.integers(0, m, shape) / m + np.pi / m
    x = np.stack([np.cos(ang), np.sin(ang)], -1)
    return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)


@pytest.mark.parametrize("mask", ["every", "tiles"])
@pytest.mark.parametrize("layout,C,F", [("lane-major", 37, 1),
                                        ("rows", 100, 2),
                                        ("permuted", 20, 10)])
@pytest.mark.parametrize("modcod", ["qpsk1/2", "16apsk2/3"])
def test_plsync_payload_kernels_at_layouts(card, modcod, layout, C, F,
                                           mask):
    """The statistics and demap kernels against the plain version (phase
    14's checks, ``_payload_case``) at B = C F not a multiple of 32: the
    lane-major (N, B) LLRs from per-lane starts into one buffer, VCM's (B,
    N + 64) rows, and ``BatchedPipeline``'s permuted lane-major payload
    view (component stride C F); every lane, or a mask that empties a
    whole 32-lane tile and thins the rest."""
    from dvbs2rx_tpu_torch.ops import plsync_cuda
    from dvbs2rx_tpu_torch.spec.scramblers import pl_descrambling_sequence

    cfg = RxConfig(modcod=modcod, frame_size="short", pilots=True)
    info = cfg.pls_info
    Lp, R, B = info.payload_len, info.n_slots * 90, C * F
    N = R * info.n_mod
    rng = np.random.default_rng(B + info.n_mod)
    if layout == "permuted":
        pay = torch.as_tensor(_lane_symbols(rng, info.n_mod, (C, F, Lp))
                              .transpose(2, 3, 0, 1).copy(), device=card)
        sym, start, rows = pay.permute(2, 3, 0, 1), None, Lp
        assert sym.stride() == (F, 1, 2 * C * F, C * F)
    else:
        rows = Lp + 3000
        buf = torch.as_tensor(_lane_symbols(rng, info.n_mod, (C, rows)),
                              device=card)
        sym = buf[:, None].expand(C, F, rows, 2)
        start = torch.as_tensor(rng.integers(-50, rows - Lp + 50, B),
                                device=card)
    sel = None
    if mask == "tiles":
        m = rng.random(B) < 0.6
        m[32:64] = False
        sel = torch.as_tensor(m, device=card)
    llr = (torch.empty((N, B), dtype=torch.int8, device=card)
           if layout != "rows" else
           torch.empty((B, N + 64), dtype=torch.int8, device=card).t())
    kw = dict(sym=sym, start=start, clamp_len=Lp,
              descr=torch.as_tensor(cplx.from_np(pl_descrambling_sequence(
                  cfg.gold_code)[:Lp]).astype(np.float32), device=card),
              ph=torch.as_tensor(rng.uniform(-3, 3, (B, 2, 2)).astype(
                  np.float32), device=card),
              cc=torch.as_tensor(rng.random(B) < 0.7, device=card),
              n0_ov=torch.as_tensor(np.where(rng.random(B) < 0.3, 0.1, -1.0)
                                    .astype(np.float32), device=card),
              info=info, constellation=cfg.constellation, rate=cfg.rate,
              llr_out=llr, sel=sel, x_every=F,
              x_out=torch.empty((C, 300, 2), device=card))
    plan = plsync_cuda.launch_plan(B, R, info.n_mod, 0, *llr.stride())
    assert plan["write_along"] == ("position" if layout == "rows"
                                   else "lane")
    rec = _payload_case(f"{layout} B = {B}", "cuda", kw)
    assert rec["selected"] == (B if sel is None else int(sel.sum()))
    assert rec["llr_ties"] <= 1e-3 * max(rec["llrs"], 1)


def test_plheader_kernel_at_the_vcm_slots(card):
    """The PLHEADER kernel over 1,344 x 2 headers (the VCM step's 21 slots
    of 64 channels: own and next, a PLS each, the full autocorrelation),
    with and without the metric, against its plain version within phase
    14's tolerances; one launch each."""
    rng = np.random.default_rng(1344)
    hdr = torch.as_tensor(rng.normal(size=(21, 64, 2, 90, 2)).astype(
        np.float32), device=card)
    pls = [torch.as_tensor(rng.integers(0, 128, 21 * 64), device=card)
           for _ in range(2)]
    for metric in (False, True):
        rec = _plheader_case("vcm slots", "cuda",
                             [hdr[:, :, 0], hdr[:, :, 1]], pls, 90, metric)
        assert rec["phase_err"] <= 1e-5


def test_ccm_lane_program_replays_identical_bytes_in_a_graph(card):
    """The CCM lane program (PLHEADER, statistics, demap) captured in a
    CUDA graph after one eager call: the capture allocates no scratch,
    two replays write the same bytes as each other and as the eager call
    (the fixed-order double sums), and the outputs hold phase 14's
    checks against the plain version."""
    from dvbs2rx_tpu_torch.ops import plsync_cuda
    from dvbs2rx_tpu_torch.parallel.batch import make_lane_fn
    from dvbs2rx_tpu_torch.spec.scramblers import pl_descrambling_sequence

    cfg = RxConfig(modcod="qpsk1/2", frame_size="normal")
    info = cfg.pls_info
    C, F, L = 8, 2, info.plframe_len
    rng = np.random.default_rng(64)
    buf = torch.as_tensor(_lane_symbols(rng, 2, (C, (F + 1) * L + 92)),
                          device=card)
    hdr = torch.stack([buf[:, k * L: k * L + 90] for k in range(F + 1)], 1)
    start = torch.as_tensor(np.tile(90 + np.arange(F) * L, C), device=card)
    cc = torch.ones(C * F, dtype=torch.bool, device=card)
    n0_ov = torch.full((C * F,), -1.0, device=card)
    descr = torch.as_tensor(cplx.from_np(pl_descrambling_sequence(
        cfg.gold_code)[: info.payload_len]).astype(np.float32), device=card)
    lane = make_lane_fn(cfg, descr)
    sym = buf[:, None].expand(C, F, buf.shape[1], 2)

    def call():
        return lane(hdr[:, :F], hdr[:, 1:], sym, start, cc, n0_ov, x_every=F)

    eager = {k: v.clone() for k, v in call().items()}
    scratch = dict(plsync_cuda._SCRATCH)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    assert plsync_cuda._SCRATCH == scratch
    replays = []
    for _ in range(2):
        for v in out.values():
            v.zero_()
        g.replay()
        torch.cuda.synchronize()
        replays.append({k: v.clone() for k, v in out.items()})
    for k in eager:
        assert torch.equal(replays[0][k], replays[1][k]), k
        assert torch.equal(replays[0][k], eager[k]), k
    phases = plsync_cuda.plheader_plain(
        [hdr[:, :F], hdr[:, 1:]], [torch.tensor([cfg.pls], device=card)] * 2
    )["phase"]
    rec = _payload_case("graph", "cuda", dict(
        sym=sym, start=start, clamp_len=info.payload_len, descr=descr,
        ph=phases, cc=cc, n0_ov=n0_ov, info=info,
        constellation=cfg.constellation, rate=cfg.rate, x_every=F,
        llr_out=eager["llrs"], x_out=eager["x0"]))
    assert rec["llr_ties"] <= 1e-3 * rec["llrs"]


# ---- the shared front end (csrc/frontend.cu, csrc/ffsync.cu) and the MF's
# in-place read: kernels against their plain versions on the card


def _fe_inputs(card, C=3, n_in=5000, N=9001, seed=30):
    rng = np.random.default_rng(seed)
    t = functools.partial(torch.tensor, device=card)
    return dict(
        iq=torch.from_numpy(rng.normal(size=(C, n_in, 2)).astype(
            np.float32)).to(card),
        gain=t([1.0, 0.5, 2.0][:C]), phase0=t([0.0, 1.3, 6.0][:C]),
        inc=t([0.0, 0.731, -20.5][:C]),
        sbuf=torch.from_numpy(rng.normal(size=(C, N, 2)).astype(
            np.float32)).to(card),
        sfill=t([100, 4500, N][:C], dtype=torch.int32))


@pytest.mark.parametrize("agc", ["off", "update", "given"])
@pytest.mark.parametrize("buffered", [False, True])
def test_frontend_kernels_match_plain(card, agc, buffered):
    """The rotated samples (rotator phases past 1e5 rad) within 1e-6 of
    their RMS of the plain rotation at the kernel's gain, the gain within
    1e-6 relative of the plain composite's, fills, starts and flags equal;
    one rotate launch a call and one AGC launch with AGC update."""
    from dvbs2rx_tpu_torch.ops import frontend_cuda as fc

    a = _fe_inputs(card)
    if not buffered:
        a["sbuf"] = a["sfill"] = None
    before = (fc.LAUNCHES, fc.AGC_LAUNCHES)
    got = fc.frontend(**{**a, "agc": agc, "alpha": 0.3, "agc_ref": 1.2})
    assert (fc.LAUNCHES, fc.AGC_LAUNCHES) == (
        before[0] + 1, before[1] + (agc == "update"))
    want = fc.frontend_plain(**{**a, "agc": agc, "alpha": 0.3,
                                "agc_ref": 1.2})
    iso = fc.frontend_plain(**{**a, "gain": got["gain"], "agc": "off"
                               if agc == "off" else "given"})
    rms = float(iso["out"].square().mean().sqrt())
    assert float((got["out"] - iso["out"]).abs().max()) <= 1e-6 * rms
    torch.testing.assert_close(got["gain"], want["gain"], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(got["phase"], want["phase"], rtol=0,
                               atol=1e-6)
    for k in ("sfill", "start", "overflow"):
        assert (k in got) == buffered
        if buffered:
            assert torch.equal(got[k], want[k]), k


def test_frontend_kernel_constants_match_the_wrapper(card):
    from dvbs2rx_tpu_torch import _build
    from dvbs2rx_tpu_torch.ops import ffsync_cuda, frontend_cuda

    lib = _build.lib()
    assert lib.frontend_chunk_samples() == frontend_cuda.CHUNK
    assert lib.frontend_tile_rows() == frontend_cuda.TILE_ROWS
    assert lib.ffsync_piece_samples() == ffsync_cuda.PIECE
    # the tracker's plan and shared memory
    for pieces in range(1, ffsync_cuda.MAX_PIECES + 1):
        assert lib.ffsync_track_plan(pieces) == \
            ffsync_cuda.plan(pieces).G, pieces
    for per in range(1, ffsync_cuda.MAX_PER + 1):
        for nb in (0, 2688, 2689, 10_752):
            assert lib.ffsync_track_smem_bytes(per, nb) == \
                ffsync_cuda.smem_bytes(per, nb)


def _track_inputs(card, n_out, in_place, C):
    """A FeedForwardSync on the card and C channels of a seeded QPSK
    short-frame waveform (offsets 0, 333, 1201, 1999 for C = 4, else 300
    apart and odd on odd channels) at 10 dB: the block of n_out symbols,
    or with ``in_place`` a buffer 2,000 rows longer and per-channel
    starts (clamped at both ends, odd and even); the tracker state
    initialised on all but channel 0."""
    from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync, FFSyncState

    sync = FeedForwardSync(sps=2, max_block=n_out, device=card)
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(n_out)
    pkts = rng.integers(0, 256, (300, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    wave = cplx.from_np(awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 10.0,
                                     sps=2, seed=3))
    length = 2 * n_out + sync.history() + 64
    N = length + 2000 if in_place else length
    offs = (0, 333, 1201, 1999) if C == 4 else \
        [300 * c + c % 2 for c in range(C)]
    x = torch.from_numpy(np.stack([wave[o: o + N] for o in offs])).to(card)
    starts = None
    if in_place:
        starts = [-9, 700, N - length + 5, N] if C == 4 else (
            [-9, N, N - length - 3, 1000] + [
                int(s) for s in rng.integers(0, N - length,
                                             max(C - 4, 0))])[:C]
    start = torch.tensor(starts, dtype=torch.int32, device=card) \
        if in_place else None
    tau = [0.0, 0.3, 1.6, -0.7] if C == 4 else rng.uniform(-1, 2, C)
    rate = [0.0, 1e-4, -2e-4, 2.2e-4] if C == 4 else \
        rng.uniform(-2e-4, 2e-4, C)
    st = FFSyncState(
        tau=torch.tensor(np.float32(tau), device=card),
        rate=torch.tensor(np.float32(rate), device=card),
        initialized=torch.tensor([0] + [1] * (C - 1), dtype=torch.int32,
                                 device=card))
    return sync, st, x, (dict(start=start, length=length) if in_place
                         else {}), length


def _check_track(sync, st, x, n_out, kw, length):
    """One tracker launch against ``_track_plain`` on the same blocks:
    consumed, offsets and taps equal but on channels within 1e-4 samples
    of a bin edge, tau and drift within 1e-3 samples; step_batched's
    symbols equal the plain MF on the kernel's own taps and offsets."""
    from dvbs2rx_tpu_torch.ops import ffsync_cuda

    before = ffsync_cuda.LAUNCHES
    new, taps, off, cons = sync._track(st, x, n_out, **kw)
    assert ffsync_cuda.LAUNCHES == before + 1
    block = cplx.window_rows(x, kw["start"], length) if kw else x
    want = sync._track_plain(st, block, n_out)
    margin = ffsync_cuda.edge_margin(sync, st, block, n_out)
    differ = ((cons != want[3]) | (off != want[2]).any(1)
              | (taps != want[1]).flatten(1).any(1))
    assert not bool((differ & (margin >= 1e-4)).any())
    assert float((new.tau - want[0].tau).abs().max()) <= 1e-3
    assert float((new.rate - want[0].rate).abs().max()) * n_out <= 1e-3
    _, syms, _ = sync.step_batched(st, x, n_out, **kw)
    S = taps.shape[1]
    if S > 1:
        ref = fir_cuda.mf_segmented_plain(block, taps, off, 2, n_out // S,
                                          sync._off)
        rms = float(ref.square().mean().sqrt())
        assert float((syms - ref).abs().max()) <= 1e-5 * rms


@pytest.mark.parametrize("n_out,in_place,C", [
    (9000, True, 4), (9000, False, 4), (4096, True, 4), (4099, False, 4),
    (9000, True, 64),       # 16 windows, 8 blocks a channel
    (8140, True, 1),        # one window of 16,383 samples: 8 blocks
])
def test_ffsync_track_kernel_matches_plain(card, n_out, in_place, C):
    """Multi-window (n_out 9000) and single-window blocks (4,096 / 4,099
    symbols: 9 pieces; 8,140: 16), in place from a longer buffer at starts
    clamped at both ends, odd and even, or whole, at C = 4, 64 and 1 (the
    plan's clusters of 8 and 5 blocks a channel): the kernel against the
    plain tracker (``_check_track``); at C = 1 one launch per start."""
    sync, st, x, kw, length = _track_inputs(card, n_out, in_place, C)
    if C > 1:
        _check_track(sync, st, x, n_out, kw, length)
        return
    N = x.shape[1]
    for s in (-5, N, N - length - 3, 1000):
        kw["start"] = torch.tensor([s], dtype=torch.int32, device=card)
        _check_track(sync, st, x, n_out, kw, length)


@pytest.mark.parametrize("n_out,C", [(9000, 64), (8140, 1)])
def test_ffsync_track_in_a_graph_replays_the_eager_bytes(card, n_out, C):
    """The tracker's cluster launch captured in a CUDA graph after a
    warm-up call: each replay writes the eager launch's bytes (the
    partials combined in a fixed order through distributed shared memory,
    no atomics, no scratch)."""
    sync, st, x, kw, _ = _track_inputs(card, n_out, True, C)
    want = sync._track(st, x, n_out, **kw)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        sync._track(st, x, n_out, **kw)
    torch.cuda.current_stream(card).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = sync._track(st, x, n_out, **kw)
    for _ in range(3):
        for t in (out[0].tau, out[0].rate, out[0].initialized, *out[1:]):
            t.zero_()
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip((out[0].tau, out[0].rate, out[0].initialized,
                         *out[1:]),
                        (want[0].tau, want[0].rate, want[0].initialized,
                         *want[1:])):
            assert torch.equal(a, b)


def test_ffsync_refused_cluster_launch_raises(card, monkeypatch):
    """A launch the card refuses (a subfilter bank too large for a block's
    shared memory) raises, counts no launch and never runs the plain
    tracker; the wrapper refuses such a bank before launching."""
    from dvbs2rx_tpu_torch.ops import ffsync_cuda
    from dvbs2rx_tpu_torch.ops.ffsync import FeedForwardSync

    _, st, x, _, length = _track_inputs(card, 4096, False, 4)
    sync = FeedForwardSync(sps=2, max_block=4096, n_subfilt=4096,
                           device=card)

    def plain(*args, **kw):
        raise AssertionError("the plain tracker ran on CUDA tensors")

    monkeypatch.setattr(sync, "_track_plain", plain)
    before = ffsync_cuda.LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        sync._track(st, x, 4096)
    with pytest.raises(RuntimeError, match="ffsync_track_kernel"):
        ffsync_cuda._launch(sync, (st.tau, st.rate, st.initialized), x,
                            4096, None, length, sync.segments(4096))
    assert ffsync_cuda.LAUNCHES == before


@pytest.mark.parametrize("C,S,seg_len,L,off", [(4, 15, 333, 21, 23),
                                               (1, 1, 1000, 21, 16)])
def test_mf_kernel_reads_in_place(card, C, S, seg_len, L, off):
    """Per-channel block starts into a longer buffer, clamped at both
    ends, odd and even (8-byte and 16-byte aligned rows): the kernel
    within 1e-5 of the plain version on the gathered blocks, one launch
    recorded under the in-place layout."""
    rng = np.random.default_rng(seg_len + 7)
    length = (S * seg_len - 1) * 2 + L + off + 3
    n = length + 101
    x = torch.from_numpy(rng.normal(size=(C, n, 2)).astype(
        np.float32)).to(card)
    taps = torch.from_numpy((rng.normal(size=(C, S, L)) / np.sqrt(L)).astype(
        np.float32)).to(card)
    base = torch.from_numpy(rng.integers(-3, off + 4, (C, S)).astype(
        np.int32)).to(card)
    start = torch.tensor([-4, n, 37, 50][:C], dtype=torch.int32,
                         device=card)
    key = (C, n, S, seg_len, L, 2, off, length)
    shape_before = fir_cuda.LAUNCH_SHAPES.get(key, 0)
    got = fir_cuda.mf_segmented(x, taps, base, 2, seg_len, off, start,
                                length)
    assert fir_cuda.LAUNCH_SHAPES[key] == shape_before + 1
    want = fir_cuda.mf_segmented_plain(cplx.window_rows(x, start, length),
                                       taps, base, 2, seg_len, off)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_stream_frontend_in_a_graph_replays_the_eager_bytes(card):
    """The CCM step's front end (AGC partial sums with their scratch, the
    rotate-and-append kernel, the tracker and the MF in place) captured as
    one CUDA graph after a warm-up call: a replay writes the eager call's
    bytes (fixed-order sums, no atomics)."""
    sr = StreamReceiver(RxConfig(modcod="qpsk1/2", frame_size="short"), 4,
                        device=card)
    rng = np.random.default_rng(31)
    st = sr.init_state_np()
    st["sbuf"][:] = rng.normal(size=st["sbuf"].shape)
    st["sfill"][:] = sr._n_fe - sr.n_in + 17
    st["rot_inc"][:] = 2e-3
    state = state_from_numpy(st, card)
    iq = torch.from_numpy(rng.normal(size=(4, sr.n_in, 2)).astype(
        np.float32)).to(card)
    want = sr._frontend(state, iq)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        sr._frontend(state, iq)
    torch.cuda.current_stream(card).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = sr._frontend(state, iq)
    g.replay()
    torch.cuda.synchronize()
    for k in ("sbuf", "sfill", "agc_gain", "rot_phase", "ff_tau", "ff_rate"):
        assert torch.equal(out[0][k], want[0][k]), k
    assert torch.equal(out[1], want[1])


# ------------------------------------------------- post-decoder SNR refinement

SNR_RTOL = 1e-5     # float32 sums in another order than the plain version's
SNR_CASES = [       # constellation, rate, B, rows, R, bits layout
    ("QPSK", "1/2", 64, 32400, 32400, "lanes"),   # the CCM step, lane-major
    ("QPSK", "1/2", 64, 32400, 32400, "rows"),    # the CCM step's LDPC rows
    ("QPSK", "1/2", 128, 32400, 4096, "rows"),    # a VCM batch, R_SUB rows
    ("8PSK", "3/5", 37, 21600, 4096, "rows"),     # VCM 8PSK 3/5, interleaved
    ("8PSK", "3/5", 64, 21600, 21600, "lanes"),
    ("16APSK", "2/3", 8, 16200, 16200, "rows"),
    ("16APSK", "2/3", 70, 4050, 4000, "lanes"),   # a ragged frame tile
    ("32APSK", "3/4", 8, 12960, 12960, "lanes"),
    ("32APSK", "3/4", 3, 3240, 3000, "rows"),
    ("QPSK", "1/2", 1, 32400, 32400, "rows"),     # B = 1: a host frame
    ("8PSK", "3/5", 1, 5400, 5400, "lanes"),
]


@pytest.mark.parametrize("constellation,rate,B,rows,R,layout", SNR_CASES)
def test_snr_kernel_matches_plain(card, constellation, rate, B, rows, R,
                                  layout):
    """One launch against the plain version on the CPU: each frame's SNR
    within SNR_RTOL; the N0 rule exact on the kernel's SNR; a second launch
    (the ticket reset by the first) equal bit for bit."""
    from dvbs2rx_tpu_torch.ops import snr_cuda
    from dvbs2rx_tpu_torch.rx.receiver import _snr_refine_frames

    x, hard = _snr_inputs(card, constellation, rate, B, rows, R, layout,
                        seed=B + rows + R)
    assert snr_cuda.layout(hard) == (layout if B > 1 else "rows")
    n_mod = hard.shape[1] // rows
    want = _snr_refine_frames(x.cpu(), hard.cpu(), constellation, rate,
                              n_mod)
    n0 = torch.linspace(0.0, 1.0, B, device=card)
    before = snr_cuda.LAUNCHES
    got, none = snr_cuda.snr_refine(x, hard, constellation, rate, n_mod)
    again, n0_out = snr_cuda.snr_refine(x, hard, constellation, rate, n_mod,
                                        n0)
    torch.cuda.synchronize()
    assert snr_cuda.LAUNCHES == before + 2 and none is None
    torch.testing.assert_close(got.cpu(), want, rtol=SNR_RTOL, atol=0)
    assert torch.equal(again, got)
    snr = got.cpu()
    assert torch.equal(n0_out.cpu(), torch.where(
        snr > 0, 1.0 / snr.clamp(min=1e-9), n0.cpu()))


def test_snr_kernel_clamps_and_passes_nan(card):
    """A frame on its points (error power 0: sp / 1e-12), a frame of zeros
    (SNR 1) and a frame with a NaN symbol (NaN SNR, the carried N0 kept),
    as the plain version gives them."""
    from dvbs2rx_tpu_torch.ops import snr_cuda
    from dvbs2rx_tpu_torch.rx.receiver import _snr_refine_frames

    x, hard = _snr_inputs(card, "8PSK", "3/5", 4, 5400, 5400, "rows", seed=7,
                        noise=0.0)
    x[1] = 0.0
    x[2, 100, 0] = float("nan")
    want = _snr_refine_frames(x.cpu(), hard.cpu(), "8PSK", "3/5", 3)
    n0 = torch.full((4,), 0.5, device=card)
    got, n0_out = snr_cuda.snr_refine(x, hard, "8PSK", "3/5", 3, n0)
    got, n0_out = got.cpu(), n0_out.cpu()
    torch.testing.assert_close(got, want, rtol=SNR_RTOL, atol=0,
                               equal_nan=True)
    assert float(got[0]) > 1e15 and abs(float(got[1]) - 1.0) < 1e-5
    assert torch.isnan(got[2]) and float(n0_out[2]) == 0.5
    assert torch.equal(n0_out[[0, 1, 3]], 1.0 / got[[0, 1, 3]].clamp(
        min=1e-9))


def test_snr_kernel_in_a_graph_replays_the_eager_bits(card):
    """The launch with the N0 update captured in a CUDA graph after a
    warm-up call: every replay writes the eager launch's bits."""
    from dvbs2rx_tpu_torch.ops import snr_cuda

    x, hard = _snr_inputs(card, "QPSK", "1/2", 64, 32400, 32400, "rows",
                        seed=11)
    n0 = torch.full((64,), 0.25, device=card)
    want = snr_cuda.snr_refine(x, hard, "QPSK", "1/2", 2, n0)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        snr_cuda.snr_refine(x, hard, "QPSK", "1/2", 2, n0)
    torch.cuda.current_stream(card).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = snr_cuda.LAUNCHES
    with torch.cuda.graph(g):
        out = snr_cuda.snr_refine(x, hard, "QPSK", "1/2", 2, n0)
    assert snr_cuda.LAUNCHES == before + 1
    for _ in range(3):
        out[0].zero_()
        out[1].zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_snr_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from dvbs2rx_tpu_torch.ops import snr_cuda

    x, hard = _snr_inputs(card, "QPSK", "1/2", 2, 900, 900, "rows", seed=3)
    n0 = torch.zeros((2,), device=card)
    before = snr_cuda.LAUNCHES
    for args, kw in (
            ((x.double(), hard), {}),
            ((x, hard.to(torch.int8)), {}),
            ((x[:1], hard), {}),
            ((x, hard[:, :1799]), {}),
            ((torch.cat([x, x], 1), hard), {}),
            ((torch.cat([x, x], 1)[:, ::2], hard), {}),
            ((x.flatten()[1:1801].view(1, 900, 2), hard[:1]), {}),
            ((x, hard), {"n0": n0[:1]}),
            ((x, hard), {"n0": n0.double()}),
            ((x.cpu(), hard.cpu()), {})):
        with pytest.raises(ValueError):
            snr_cuda.snr_refine(*args, "QPSK", "1/2", 2, **kw)
    with pytest.raises(ValueError):
        snr_cuda.snr_refine(x, hard, "QPSK", "1/2", 3)
    assert snr_cuda.LAUNCHES == before


def test_every_card_path_runs_the_snr_kernel(card):
    """On CUDA tensors ``_snr_refine_frames`` launches the kernel: the CCM
    step once a step (with the N0 update), the VCM step once per decoded
    batch (as many as its LDPC launches) and the host ``Receiver`` once
    per FEC batch with snapshots."""
    from dvbs2rx_tpu_torch.ops import snr_cuda
    from dvbs2rx_tpu_torch.rx.receiver import make_receiver
    from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

    C, F, T = 2, 2, 2
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short")
    sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F, device=card)
    tx = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short"))
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (120, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq = np.stack([awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 15.0, sps=2,
                                seed=1)] * C)
    state = sr.prime(iq[:, : sr._n_fe])
    n0 = snr_cuda.LAUNCHES
    for t in range(T):
        blk = cplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                              sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
        state, _, st = sr.step(state, sr.put_iq(blk))
    assert snr_cuda.LAUNCHES == n0 + T
    assert bool((st["snr_refined"] > 0).all())
    assert bool((state["n0_refined"] > 0).all())
    vcfg, viq = _vcm_case([0, 1], 420)
    vr = VCMStreamReceiver(vcfg, 2, 2, fec_lanes=8, device=card)
    state = vr.prime(viq[:, : vr._n_fe])
    n0, n_ldpc = snr_cuda.LAUNCHES, ldpc_cuda.LAUNCHES
    for t in range(6):
        blk = cplx.from_np(viq[:, vr._n_fe + t * vr.n_in:
                               vr._n_fe + (t + 1) * vr.n_in]
                           ).astype(np.float32)
        state, _, st = vr.step(state, vr.put_iq(blk))
    assert snr_cuda.LAUNCHES - n0 == ldpc_cuda.LAUNCHES - n_ldpc > 0
    hcfg = RxConfig(modcod="qpsk1/2", frame_size="short")
    rx = make_receiver(hcfg, device=card)
    n0 = snr_cuda.LAUNCHES
    rx.receive(iq[0])
    assert snr_cuda.LAUNCHES > n0 and rx.stats.bch_frame_errors == 0


def test_apsk_lane_program_on_the_card_matches_the_plain_reference(card):
    """``tests/test_torch_apsk.py``'s lane comparison on the card: the PL
    sync kernels on 2 normal piloted 16APSK 3/4 frames (the pilot-mode
    statistics, the 16APSK max-log demap tiles) against the float64
    reference, within that file's tolerances; and the rate-3/4 LDPC
    kernel's per-frame iterations and bits against the plain decoder's on
    the lanes' LLRs."""
    from rxbench.reference import payload as ref
    from test_torch_apsk import (PLS, apsk_frames, apsk_gaps, apsk_lane,
                                 apsk_within)

    y, L, cws = apsk_frames()
    cc, n0_ov = torch.tensor([True, True]), torch.tensor([-1.0, 0.05])
    out, fec = apsk_lane(y, L, cc, n0_ov, card)
    pair = torch.from_numpy(np.stack([y[:L], y[L: 2 * L]]))
    want = ref.frame_payload(pair, PLS, n0_ov, cc)
    g = apsk_gaps(out, want)
    assert apsk_within(g, want["llrs"].numel()), g
    llrs = out["llrs"].to(card)
    got = fec.ldpc.decode_frames(llrs)
    plain = LDPCDecoder(fec.ldpc.code, fec.ldpc.max_trials, "cpu") \
        .decode_frames(llrs.cpu())
    for a, b, what in zip(got, plain, ("hard", "llrs", "iters", "conv")):
        assert torch.equal(a.cpu(), b), what
    assert bool(plain[3].all())
    np.testing.assert_array_equal(plain[0][: cws.shape[1]].t().numpy(), cws)
