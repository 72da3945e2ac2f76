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

import numpy as np
import pytest
import torch

from dvbs2rx_tpu_torch.spec import bch_spec
from dvbs2rx_tpu_torch.spec.ldpc_tables import available_tables, get_code
from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig, awgn_channel

from dvbs2rx_tpu_torch.convert import state_to_numpy, state_from_numpy
from dvbs2rx_tpu_torch.ops import cplx, fir_cuda, ldpc_cuda
from dvbs2rx_tpu_torch.ops.bch import BCHDecoder
from dvbs2rx_tpu_torch.ops.crc8_dev import packet_validity
from dvbs2rx_tpu_torch.ops.ldpc import LDPCDecoder
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import StreamReceiver

from chip_smoke import _gardner_waveform

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
    got = fir_cuda.mf_segmented(x, taps, base, 2, seg_len, off)
    assert fir_cuda.LAUNCHES == before + 1
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
    got = ldpc_cuda.CudaLDPCDecoder(code, trials, card).decode_lane_major(xT)
    assert ldpc_cuda.LAUNCHES == before + 1
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
        if tile:
            monkeypatch.setattr(
                gardner_cuda, "launch_plan",
                lambda n, W, mid, tf: gardner_cuda.GardnerPlan(
                    tf, tile, -(-tf * 4 // 16) * 16 + 8 * tile))
        got_st, got = sync.step(st, x, n_out)
        for k in GARDNER_INT + GARDNER_FLOAT:
            torch.testing.assert_close(getattr(got_st, k),
                                       getattr(want_st, k), rtol=0,
                                       atol=1e-5)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    monkeypatch.setattr(gardner_cuda, "launch_plan", plan)


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
