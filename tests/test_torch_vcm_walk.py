"""The VCM chain walk: the port's plain loop against the JAX ``_walk``, and
the CUDA kernel's wrapper and tables on the CPU.

Configuration: ``tests/test_torch_vcm.py``'s (C = 2 channels, piloted short
QPSK 1/2 (PLS 17 short) and 8PSK 3/5 alternating at Es/N0 15 dB, 2 frames
per step, 8 FEC lanes), in each of the three PLSC modes. A state is the
port's primed state after one ``_append_symbols`` with ``fp_right +=
n_out`` (what ``_step_a`` hands the walk), carried to the JAX receiver by
``convert.vcm_state_to_numpy``. Cases: that state; a ring too fresh for
the chain (``pos < have``, dead from slot 0); a ring of dummy frames that
keeps all but the last slot alive; ``coarse_corrected`` mixed across the
channels; first frames where the windows clamp (at 0, and near the ring's
end). Integer outputs and headers (gathered symbols) exactly; the
frame metric within ``tests/test_torch_vcm.py``'s tolerance (rtol 1e-4,
atol 1e-3: float32 sums in another order than XLA's on the CPU).

The kernel (``csrc/vcm_walk.cu``, the walk and its books in one launch)
runs only on the card (``tests/test_torch_cuda.py``); here: the dispatch
of the walk and its books, the wrapper's checks, the kernel's tables, and
the dead-slot rule on the plain loop. ``tests/test_torch_vcm_books.py``
holds the books to the JAX step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.vcm_stream import VCMStreamReceiver as JVCMStreamReceiver

from dvbs2rx_tpu_torch.convert import vcm_state_to_numpy
from dvbs2rx_tpu_torch.ops import cplx, plsync, vcm_walk_cuda
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver
from dvbs2rx_tpu_torch.spec.pls import make_pls, parse_pls
from dvbs2rx_tpu_torch.tx import TxConfig, awgn_channel
from dvbs2rx_tpu_torch.tx.vcm import VCMTransmitter

torch.set_num_threads(2)

C, F, LANES = 2, 2, 8
PLS_A = make_pls(4, True, True)      # qpsk1/2 short, pilots
PLS_B = make_pls(12, True, True)     # 8psk3/5 short, pilots
BASE = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
            pls_expected=(PLS_A, PLS_B), coarse_period=2)
MODES = ("coherent-soft", "coherent-hard", "differential")
CASES = ("primed", "fresh", "dummy", "mixed", "edges")
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-3   # tests/test_torch_vcm.py FLOAT_ATOL
WALK_KEYS = ("symbuf", "fp_right", "symfill", "pls", "coarse_corrected")


def _txs():
    return [TxConfig(modcod="qpsk1/2", frame_size="short", pilots=True),
            TxConfig(modcod="8psk3/5", frame_size="short", pilots=True)]


@functools.lru_cache(maxsize=1)
def _states():
    """The four cases' walk inputs as port tensors, from one receiver
    (the walk's inputs do not depend on the PLSC mode)."""
    sr = VCMStreamReceiver(RxConfig(**BASE), C, F, LANES, device="cpu")
    vtx = VCMTransmitter(_txs())
    rng = np.random.default_rng(0)
    pkts = rng.integers(0, 256, (200, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    clean = vtx.ts_to_iq(pkts.reshape(-1), [0, 1])
    n = sr._n_fe + sr.n_in
    iq = np.stack([awgn_channel(clean[:n], 15.0, sps=2, freq_offset=5e-6,
                                seed=1 + c) for c in range(C)])
    state = sr.prime(iq[:, : sr._n_fe])
    blk = torch.from_numpy(cplx.from_np(iq[:, sr._n_fe: n]).astype(
        np.float32))
    state, _, _ = sr._append_symbols(state, blk)
    primed = {k: state[k] for k in WALK_KEYS}
    primed["fp_right"] = primed["fp_right"] + sr.n_out
    # a fresh ring: the first buffered symbol lies past the chain's start
    fresh = dict(primed, symfill=torch.tensor([300, sr.n_out],
                                              dtype=torch.int32))
    # dummy frames after one QPSK frame; each channel starts on a dummy
    syms = vtx.modulate_ts(pkts.reshape(-1)[: 188 * 40], [0] + [-1] * 12)
    L0 = parse_pls(PLS_A).plframe_len
    noise = rng.normal(0, 0.1, (C, sr.N_SYM, 2))
    ring = cplx.from_np(syms[: sr.N_SYM]) + noise
    dummy = dict(
        primed, symbuf=torch.from_numpy(ring.astype(np.float32)),
        symfill=torch.full((C,), sr.N_SYM, dtype=torch.int32),
        fp_right=torch.tensor([sr.N_SYM - L0, sr.N_SYM - L0 - 3330],
                              dtype=torch.int32),
        pls=torch.zeros((C,), dtype=torch.int32),
        coarse_corrected=torch.tensor([True, False]))
    mixed = dict(primed, coarse_corrected=torch.tensor([True, False]))
    # the first frames where the windows clamp: at 0 and near the end
    edges = dict(mixed, fp_right=torch.tensor([sr.N_SYM, 50],
                                              dtype=torch.int32),
                 symfill=torch.full((C,), sr.N_SYM, dtype=torch.int32))
    return {"primed": primed, "fresh": fresh, "dummy": dummy, "mixed": mixed,
            "edges": edges}


@functools.lru_cache(maxsize=len(MODES))
def _receivers(mode):
    """(port receiver, the JAX receiver's walk, jitted) in PLSC ``mode``."""
    sr = VCMStreamReceiver(RxConfig(**BASE, plsc_mode=mode), C, F, LANES,
                           device="cpu")
    jsr = JVCMStreamReceiver(JRxConfig(**BASE, plsc_mode=mode),
                             n_channels=C, frames_per_step=F,
                             fec_lanes=LANES)
    return sr, jax.jit(jsr._walk)


def _jax_walk(jwalk, state):
    st = vcm_state_to_numpy(dict(state))
    return jwalk({k: jnp.asarray(st[k]) for k in WALK_KEYS})


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_walk_matches_jax(mode, case):
    sr, jwalk = _receivers(mode)
    state = _states()[case]
    slots, fp_right, pls, n_walked = sr._walk_plain(state)
    jslots, jfp, jpls, jn = _jax_walk(jwalk, state)
    assert set(slots) == set(jslots)
    for k, v in jslots.items():
        v = np.asarray(v)
        got = slots[k].numpy()
        assert got.shape == v.shape, k
        if k == "metric":
            np.testing.assert_allclose(got, v, rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)
    for ours, theirs in ((fp_right, jfp), (pls, jpls), (n_walked, jn)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    K = sr.K_max
    walked = n_walked.numpy()
    if case == "fresh":
        assert (walked == 0).all()
    elif case == "edges":
        assert walked[1] == 0
    elif case == "dummy":
        # every slot but the last walks a dummy frame on channel 0
        assert walked[0] == K - 1 and walked.min() >= K - 2
        assert (slots["pls"].numpy()[slots["valid"].numpy()] < 4).all()
    else:
        assert (walked >= 2).all()


@pytest.mark.parametrize("case", CASES)
def test_dead_slots_repeat_the_first_dead_slot(case):
    """The kernel's early stop: once a chain is dead at slot k, slots k+1..
    equal slot k in every output, and the carry is slot k's frame."""
    sr, _ = _receivers("coherent-soft")
    slots, fp_right, pls, n_walked = sr._walk_plain(_states()[case])
    for c in range(C):
        k = int(n_walked[c])
        assert not slots["valid"][k:, c].any()
        assert slots["valid"][:k, c].all()
        if k == sr.K_max:
            continue
        for name, v in slots.items():
            torch.testing.assert_close(v[k:, c], v[k: k + 1, c].expand_as(
                v[k:, c]), rtol=0, atol=0, msg=name)
        assert int(fp_right[c]) == sr.N_SYM - int(slots["pos"][k, c])
        assert int(pls[c]) == int(slots["pls"][k, c])


def _full(sr, state, seed=5):
    """``state`` with the books' leaves (lock count, coarse accumulator,
    frames, settle and estimate), seeded."""
    rng = np.random.default_rng(seed)
    return dict(
        state,
        unlock_cnt=torch.tensor(rng.integers(0, 3, C), dtype=torch.int32),
        coarse_frames=torch.tensor(rng.integers(0, 2, C), dtype=torch.int32),
        settle=torch.tensor(rng.integers(0, 2, C), dtype=torch.int32),
        coarse_acc=torch.from_numpy(rng.normal(size=(C, 89, 2)).astype(
            np.float32)),
        coarse_foffset=torch.zeros(C))


def test_walk_takes_the_plain_loop_on_cpu():
    """On CPU tensors the walk and its books are the plain composite,
    ``_walk_plain`` and the books (no launch); its lanes are the plain
    walk's data slots."""
    sr, _ = _receivers("coherent-hard")
    state = _full(sr, _states()["mixed"])
    before = vcm_walk_cuda.LAUNCHES
    a = sr._walk_books(state)
    b = sr._walk_books_plain(state)
    assert vcm_walk_cuda.LAUNCHES == before
    for k in a["lanes"]:
        torch.testing.assert_close(a["lanes"][k], b["lanes"][k], rtol=0,
                                   atol=0)
    for k in set(a) - {"lanes"}:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    slots, fp_right, pls, n_walked = sr._walk_plain(state)
    torch.testing.assert_close(a["fp_right"], fp_right, rtol=0, atol=0)
    torch.testing.assert_close(a["pls"], pls, rtol=0, atol=0)
    torch.testing.assert_close(a["n_walked"], n_walked, rtol=0, atol=0)
    for c in range(C):
        data = [k for k in range(sr.K_max) if bool(slots["valid"][k, c])
                and int(slots["pls"][k, c]) in sr.pls_set]
        assert int(a["counts"][c]) == len(data)
        for f, k in enumerate(data[: sr.F_pay]):
            assert int(a["lanes"]["pos"][c, f]) == int(slots["pos"][k, c])
            torch.testing.assert_close(a["lanes"]["next_hdr"][c, f],
                                       slots["next_hdr"][k, c], rtol=0,
                                       atol=0)


def _args(sr, state, **kw):
    args = dict(state=_full(sr, state), search_mask=sr._search_mask,
                enabled_mask=sr._enabled_tab, K=sr.K_max, F_pay=sr.F_pay,
                L_max=sr.L_max, mode=sr.cfg.plsc_mode,
                coarse_period=sr.cfg.coarse_period)
    for k, v in kw.items():
        if k in args:
            args[k] = v
        else:
            args["state"] = dict(args["state"], **{k: v})
    return args


@pytest.mark.parametrize("bad,match", [
    ("noncontiguous", "contiguous"),
    ("int64_pls", "pls"),
    ("float64_ring", "symbuf"),
    ("short_ring", "symbuf"),
    ("mode", "PLSC mode"),
    ("short_mask", "search_mask"),
    ("cpu", "CUDA tensors"),
    ("int64_unlock", "unlock_cnt"),
    ("acc_shape", "coarse_acc"),
    ("float64_foffset", "coarse_foffset"),
    ("short_enabled", "enabled_mask"),
    ("too_many_slots", "K 65"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    sr, _ = _receivers("coherent-soft")
    state = _states()["primed"]
    ring = state["symbuf"]
    kw = {"noncontiguous": dict(symbuf=ring.transpose(0, 1).contiguous()
                                .transpose(0, 1)),
          "int64_pls": dict(pls=state["pls"].to(torch.int64)),
          "float64_ring": dict(symbuf=ring.double()),
          "short_ring": dict(symbuf=ring[:, :95].contiguous()),
          "mode": dict(mode="blind"),
          "short_mask": dict(search_mask=sr._search_mask[:64]),
          "cpu": {},
          "int64_unlock": dict(unlock_cnt=torch.zeros(C, dtype=torch.int64)),
          "acc_shape": dict(coarse_acc=torch.zeros(C, 90, 2)),
          "float64_foffset": dict(coarse_foffset=torch.zeros(
              C, dtype=torch.float64)),
          "short_enabled": dict(enabled_mask=sr._enabled_tab[:64]),
          "too_many_slots": dict(K=vcm_walk_cuda.MAX_K + 1)}[bad]
    before = vcm_walk_cuda.LAUNCHES
    with pytest.raises(ValueError, match=match):
        vcm_walk_cuda.vcm_walk(**_args(sr, state, **kw))
    assert vcm_walk_cuda.LAUNCHES == before


def test_kernel_tables_hold_the_plain_constants():
    """The kernel's tables decode back to the plain version's constants:
    the frame lengths, the transform's PLS table (every PLS once), the
    scrambler and dummy bits, the metric taps, SOF symbols, derotation
    factors, coarse weights and the float32 scalars."""
    sr, _ = _receivers("coherent-soft")
    it = vcm_walk_cuda.int_table().view(np.uint32)
    assert it.shape == (262,)
    np.testing.assert_array_equal(it[:128], sr._L_tab.numpy())
    np.testing.assert_array_equal(it[128:256],
                                  vcm_walk_cuda.wht_table().reshape(-1))
    assert sorted(it[128:256]) == list(range(128))

    def bits(words):
        w = words.astype(np.uint64)
        return ((w[:, None] >> np.arange(32, dtype=np.uint64)) & 1).reshape(-1)

    np.testing.assert_array_equal(bits(it[256:258]),
                                  plsync.PLSC_SCRAMBLER_BITS)
    np.testing.assert_array_equal(bits(it[258:262]), sr._dummy_tab.numpy())
    ft = vcm_walk_cuda.float_table()
    assert ft.shape == (360, 2)
    ks, kp = plsync._frame_metric_taps()
    np.testing.assert_array_equal(ft[:89], ks)
    np.testing.assert_array_equal(ft[89:178], kp)
    np.testing.assert_array_equal(ft[178:204],
                                  plsync.plheader_conj_lut()[0, :26])
    np.testing.assert_array_equal(ft[204:268], plsync._pi2_derot_factors())
    np.testing.assert_array_equal(ft[268:357, 0], plsync.coarse_weights(90))
    assert (ft[268:357, 1] == 0).all()
    two_pi = np.float32(2 * np.pi)
    np.testing.assert_array_equal(ft[357:], np.array(
        [[np.pi, two_pi], [plsync.FINE_FOFFSET_CORR_RANGE, 25.0],
         [np.float32(1) / two_pi, 0]], np.float32))
