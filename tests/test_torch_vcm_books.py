"""The VCM step's walk books: the port's plain composite against the JAX
step, and the walk kernel's PLSC transform on the CPU.

Configuration: ``tests/test_torch_vcm.py``'s (C = 2 channels, piloted
short QPSK 1/2 (PLS 17 short) and 8PSK 3/5 at Es/N0 15 dB, a small CFO, 2
frames per step, 8 FEC lanes, a 2-frame coarse period). Each case starts
from the JAX receiver's primed state, forced where the recurrences branch
(random stimuli rarely reach them), and runs one step A of both
receivers: the port's on the CPU is ``_walk_plain`` followed by the books
(``_walk_books_plain``), the plain version of ``csrc/vcm_walk.cu``.
Cases: the stream as primed; ``coarse_frames = coarse_period - 1`` (the
estimate fires on the first walked slot and again mid-walk); ``settle >
0`` uncorrected (the skip path); a ring scaled by 0.2 (walked metrics
below THRESHOLD_LOCKED: the unlock count); a stream of 8PSK frames only,
whose first step walks more data slots than F_pay lanes (``counts``
against the lanes). The carried lock, coarse and sequence leaves and the
step's counts must be equal; floats within ``tests/test_torch_vcm.py``'s
tolerances (rtol 1e-4: float32 sums in another order than XLA's).

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 6 (b)); here its PLSC decode's arithmetic (the
descrambled pair sums, a Walsh-Hadamard transform, ``wht_table``) is
mirrored in numpy against the plain decoders' scores.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.vcm_stream import VCMStreamReceiver as JVCMStreamReceiver

from dvbs2rx_tpu_torch.convert import vcm_state_from_numpy, vcm_state_to_numpy
from dvbs2rx_tpu_torch.ops import cplx, plsync, vcm_walk_cuda
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
from dvbs2rx_tpu_torch.spec.pl_defs import PLSC_SCRAMBLER_BITS
from dvbs2rx_tpu_torch.spec.pls import make_pls
from dvbs2rx_tpu_torch.tx import TxConfig, awgn_channel
from dvbs2rx_tpu_torch.tx.vcm import VCMTransmitter

torch.set_num_threads(2)

C, F, LANES = 2, 2, 8
PLS_A = make_pls(4, True, True)      # qpsk1/2 short, pilots
PLS_B = make_pls(12, True, True)     # 8psk3/5 short, pilots
BASE = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
            pls_expected=(PLS_A, PLS_B), coarse_period=2)
CASES = ("stream", "fire_mid_walk", "settle_skip", "unlock", "overflow")
EXACT_LEAVES = ("unlock_cnt", "coarse_frames", "settle", "coarse_corrected",
                "seq", "pls", "fp_right")
FLOAT_LEAVES = {"coarse_acc": 1e-5, "coarse_foffset": 1e-7,
                "cum_foffset": 1e-7, "rot_inc": 1e-7}
EXACT_STATS = ("locked", "n_walked", "frames", "dummies", "rejected",
               "coarse_corrected", "seq", "fp_right")


@functools.lru_cache(maxsize=1)
def _receivers():
    sr = VCMStreamReceiver(RxConfig(**BASE), C, F, LANES, device="cpu")
    jsr = JVCMStreamReceiver(JRxConfig(**BASE), n_channels=C,
                             frames_per_step=F, fec_lanes=LANES)
    return sr, jsr


@functools.lru_cache(maxsize=2)
def _primed(schedule):
    """(the JAX primed state as numpy, the first step's block (C, n_in,
    2) float32) on a stimulus of ``schedule``'s frame kinds."""
    sr, jsr = _receivers()
    vtx = VCMTransmitter([
        TxConfig(modcod="qpsk1/2", frame_size="short", pilots=True),
        TxConfig(modcod="8psk3/5", frame_size="short", pilots=True)])
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (420, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    clean = vtx.ts_to_iq(pkts.reshape(-1), list(schedule))
    n = sr._n_fe + sr.n_in
    iq = np.stack([awgn_channel(clean[:n], 15.0, sps=2, freq_offset=5e-6,
                                seed=1 + c) for c in range(C)])
    state = {k: np.asarray(v) for k, v in
             jsr.prime(iq[:, : jsr._n_fe]).items()}
    blk = cplx.from_np(iq[:, sr._n_fe: n]).astype(np.float32)
    return state, blk


def _case(case):
    """The case's JAX-layout state (numpy) and block."""
    state, blk = _primed((1,) if case == "overflow" else (0, 1))
    state = {k: v.copy() for k, v in state.items()}
    if case == "fire_mid_walk":
        state["coarse_frames"][:] = BASE["coarse_period"] - 1
        state["settle"][:] = 0
    elif case == "settle_skip":
        state["settle"][:] = 2
        state["coarse_corrected"][:] = False
    elif case == "unlock":
        state["symbuf"] *= np.float32(0.2)
        state["unlock_cnt"][:] = 1
    return state, blk


def _books(sr, state, blk):
    """The port's books of this step (``_step_a``'s walk input)."""
    st, _, _ = sr._append_symbols(vcm_state_from_numpy(state, "cpu"),
                                  torch.from_numpy(blk))
    st = dict(st, fp_right=st["fp_right"] + sr.n_out)
    return st, sr._walk_books_plain(st)


@pytest.mark.parametrize("case", CASES)
def test_books_match_jax_step(case):
    sr, jsr = _receivers()
    state, blk = _case(case)
    jstate, *_, jstats = jsr._step_a(
        {k: jnp.asarray(v) for k, v in state.items()}, blk)
    ours, *_, stats = sr._step_a(vcm_state_from_numpy(state, "cpu"),
                                 torch.from_numpy(blk))
    ours = vcm_state_to_numpy(ours)
    for k in EXACT_LEAVES:
        np.testing.assert_array_equal(ours[k], np.asarray(jstate[k]),
                                      err_msg=k)
    for k, atol in FLOAT_LEAVES.items():
        np.testing.assert_allclose(ours[k], np.asarray(jstate[k]),
                                   rtol=1e-4, atol=atol, err_msg=k)
    for k in EXACT_STATS:
        np.testing.assert_array_equal(stats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)

    # the branch the case forces was taken
    st, books = _books(sr, state, blk)
    walked = books["n_walked"].numpy()
    assert (walked >= 3).all()
    cf0, period = state["coarse_frames"], BASE["coarse_period"]
    if case == "fire_mid_walk":
        # fires on slot 0 and again on slot 2, before the walk ends
        assert books["new_coarse"].all()
        np.testing.assert_array_equal(books["coarse_frames"].numpy(),
                                      (cf0 + walked) % period)
    elif case == "settle_skip":
        # slots 0 and 1 skipped, the rest accumulated
        assert (books["settle"].numpy() == 0).all()
        np.testing.assert_array_equal(books["coarse_frames"].numpy(),
                                      (cf0 + walked - 2) % period)
    elif case == "unlock":
        # the first walked slot of each channel has a weak metric
        slots = sr._walk_plain(st)[0]
        weak = slots["valid"] & (slots["metric"] <= plsync.THRESHOLD_LOCKED)
        assert weak[0].all()
    elif case == "overflow":
        counts = books["counts"].numpy()
        assert (counts > sr.F_pay).all()
        assert books["lanes"]["valid"].all()
        np.testing.assert_array_equal(stats["frames"].numpy(), counts.sum())


def test_books_contract():
    """``_walk_books_plain``'s keys, shapes and dtypes: the kernel's
    outputs (``vcm_walk_cuda.vcm_walk``) have the same."""
    sr, _ = _receivers()
    _, books = _books(sr, *_case("stream"))
    FP = sr.F_pay
    want_lanes = {"pos": ((C, FP), torch.int64),
                  "pls": ((C, FP), torch.int64),
                  "next_pls": ((C, FP), torch.int64),
                  "valid": ((C, FP), torch.bool),
                  "own_hdr": ((C, FP, 90, 2), torch.float32),
                  "next_hdr": ((C, FP, 90, 2), torch.float32)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            books["lanes"].items()} == want_lanes
    want = {"fp_right": torch.int64, "pls": torch.int64}
    want.update({k: torch.int32 for k in (
        "n_walked", "counts", "dummies", "rejected", "unlock_cnt",
        "coarse_frames", "settle")})
    want.update({k: torch.float32 for k in ("coarse_foffset",
                                            "metric_sum")})
    want.update(coarse_corrected=torch.bool, new_coarse=torch.bool)
    for k, dt in want.items():
        assert books[k].dtype == dt and tuple(books[k].shape) == (C,), k
    assert books["coarse_acc"].dtype == torch.float32
    assert tuple(books["coarse_acc"].shape) == (C, 89, 2)
    assert set(books) == set(want) | {"lanes", "coarse_acc"}


def test_step_takes_the_plain_books_on_cpu(monkeypatch):
    sr, _ = _receivers()
    state, blk = _case("stream")
    calls = []
    plain = sr._walk_books_plain
    monkeypatch.setattr(sr, "_walk_books_plain",
                        lambda st: calls.append(1) or plain(st))
    before = vcm_walk_cuda.LAUNCHES
    sr._step_a(vcm_state_from_numpy(state, "cpu"), torch.from_numpy(blk))
    assert calls == [1] and vcm_walk_cuda.LAUNCHES == before


def _wht_scores(v):
    """The kernel's PLSC scores of values v (..., 64), in numpy: lane j
    descrambles symbols 2j, 2j + 1, forms their sum and difference, and
    five butterfly stages transform each over the 32 lanes; the PLS in
    entry (j, b, s) of ``wht_table`` scores (-1)^s T_b[j]."""
    v = np.where(PLSC_SCRAMBLER_BITS.astype(bool), -v, v).astype(np.float32)
    t = np.stack([v[..., 0::2] + v[..., 1::2], v[..., 0::2] - v[..., 1::2]],
                 axis=-2)                                   # (..., 2, 32)
    lane = np.arange(32)
    for h in (1, 2, 4, 8, 16):
        o = t[..., lane ^ h]
        t = np.where(lane & h, o - t, t + o).astype(np.float32)
    tab = vcm_walk_cuda.wht_table()                         # (32, 2, 2)
    scores = np.empty(v.shape[:-1] + (128,), np.float32)
    for s in range(2):
        scores[..., tab[:, :, s].T] = (1 - 2 * s) * t
    return scores


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_wht_scores_match_the_plain_decoders(kind):
    """The transform's scores equal the plain decoders' correlations with
    the scrambled images: exactly for +-1 values (the hard and differential
    modes, exact integers), within float32 rounding for soft values; the
    argmax (first maximum) agrees."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(500, 64)).astype(np.float32)
    if kind == "hard":
        v = np.where(v < 0, -1.0, 1.0).astype(np.float32)
    ours = _wht_scores(v)
    _, theirs = plsync._ml_decode(torch.from_numpy(v), None)
    theirs = theirs.numpy()
    if kind == "hard":
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-5)
    mask = np.zeros(128, bool)
    mask[[0, 1, 2, 3, PLS_A, PLS_B, 49, 17]] = True
    got = np.where(mask, ours, -np.inf).argmax(-1)
    want, _ = plsync._ml_decode(torch.from_numpy(v),
                                torch.from_numpy(mask))
    np.testing.assert_array_equal(got, want.numpy())
