"""The port's sharded VCM stream receiver, and ``allow_dummy``.

- The port of ``tests/test_vcm_stream.py::test_sharded_vcm_matches_
  unsharded``: ``ShardedVCMStreamReceiver`` over a channel mesh of
  ``["cpu"] * 2`` against the unsharded port receiver on C = 4 channels of
  alternating short QPSK 1/2 and 3/5 frames, 8 steps: every (channel, seq,
  PLS) frame both decoded is byte-identical, they share at least 70% of
  the unsharded receiver's frames (pooling is per shard, so only the drain
  cadence differs), no BCH failure, and the sharded layout (DRAIN = D x
  DRAIN_local, global channel ids, per-shard scalars) holds.
- ``allow_dummy=False`` gives the JAX receiver's geometry (walk slots,
  lanes, queue capacity), sharded and unsharded.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import cplx as jcplx
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.vcm_stream import VCMStreamReceiver as JVCMStreamReceiver
from dvbs2rx_tpu_torch.parallel.batch import make_channel_mesh
from dvbs2rx_tpu_torch.parallel.vcm_shard import ShardedVCMStreamReceiver
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamReceiver

from tests.test_vcm_stream import PLS_A, PLS_B, vcm_waveform

torch.set_num_threads(2)

C, D, W = 4, 2, 8
KW = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
          pls_expected=(PLS_A, PLS_B))


def _collect(sr, state, iq):
    got, scalars = {}, []
    for i in range(W):
        blk = jcplx.from_np(
            iq[:, sr._n_fe + i * sr.n_in: sr._n_fe + (i + 1) * sr.n_in]
        ).astype(np.float32)
        state, outputs, stats = sr.step(state, torch.from_numpy(blk))
        scalars.append(stats)
        for si in range(sr.S):
            kb = outputs["kb"][si].numpy()
            meta = outputs["meta"][si].numpy()
            nc = outputs["n_corr"][si].numpy()
            fired = outputs["fired"][si]
            assert kb.shape[0] == sr.DRAIN and fired.shape == (sr.DRAIN,)
            for d in np.flatnonzero(fired):
                assert (nc[d] >= 0).all(), "BCH failure"
                for j in range(kb.shape[1]):
                    c, seq = int(meta[d, j, 0]), int(meta[d, j, 1])
                    got[(c, seq, si)] = kb[d, j].tobytes()
    return got, scalars


def test_sharded_vcm_matches_unsharded():
    _, iq1 = vcm_waveform((PLS_A, PLS_B), [0, 1], n_pkts=400, seed=55)
    iq = np.stack([iq1] * C)
    mesh = make_channel_mesh(["cpu"] * D)
    ssr = ShardedVCMStreamReceiver(RxConfig(**KW), n_channels=C, mesh=mesh,
                                   frames_per_step=2, fec_lanes=8)
    usr = VCMStreamReceiver(RxConfig(**KW), n_channels=C, frames_per_step=2,
                            fec_lanes=8, device="cpu")
    assert ssr.DRAIN == D * ssr.local.DRAIN
    st_s = ssr.prime(iq[:, : ssr._n_fe])
    assert ssr.prime_ok.all() and len(st_s) == D
    st_u = usr.prime(iq[:, : usr._n_fe])
    got_s, sc_s = _collect(ssr, st_s, iq)
    got_u, sc_u = _collect(usr, st_u, iq)
    common = set(got_s) & set(got_u)
    assert len(common) >= max(8, int(0.7 * len(got_u)))
    assert {c for c, _, _ in got_s} == set(range(C))
    for k in common:
        assert got_s[k] == got_u[k], f"frame {k} diverged"
    for s, u in zip(sc_s, sc_u):
        assert s["frames"].shape == (D,)
        assert int(s["frames"].sum()) == int(u["frames"])
        assert int(s["rejected"].sum()) == 0
        assert [v.shape for v in s["ldpc_iters"]] == [(D,)] * ssr.S
        assert s["n0_refined"].shape == (C, ssr.S)
        assert torch.equal(s["locked"], u["locked"])


def test_sharded_state_layout():
    mesh = make_channel_mesh(["cpu"] * D)
    ssr = ShardedVCMStreamReceiver(RxConfig(**KW), n_channels=C, mesh=mesh,
                                   fec_lanes=8)
    g = ssr.init_state_np()
    assert g["qllr"].shape[0] == D and g["sbuf"].shape[0] == C
    g["fp_right"][:] = np.arange(C)
    parts = ssr.shard_state(g)
    assert [p["fp_right"].tolist() for p in parts] == [[0, 1], [2, 3]]
    loc = ssr.local.init_state_np()
    # the port's queues keep one frame per row (``convert``)
    assert parts[0]["qllr"].shape == loc["qllr"].shape[:1] + \
        loc["qllr"].shape[:0:-1]


@pytest.mark.parametrize("allow_dummy", [True, False])
def test_allow_dummy_geometry_matches_jax(allow_dummy):
    j = JVCMStreamReceiver(JRxConfig(**KW), n_channels=C, frames_per_step=2,
                           fec_lanes=8, allow_dummy=allow_dummy)
    p = VCMStreamReceiver(RxConfig(**KW), n_channels=C, frames_per_step=2,
                          fec_lanes=8, device="cpu", allow_dummy=allow_dummy)
    for attr in ("K_max", "F_pay", "B_lanes", "DRAIN", "CAP", "N_SYM",
                 "n_out", "_settle0"):
        assert getattr(p, attr) == getattr(j, attr), attr
    mesh = make_channel_mesh(["cpu"] * D)
    s = ShardedVCMStreamReceiver(RxConfig(**KW), n_channels=C, mesh=mesh,
                                 fec_lanes=8, allow_dummy=allow_dummy)
    assert s.local.K_max == VCMStreamReceiver(
        RxConfig(**KW), n_channels=C // D, fec_lanes=8, device="cpu",
        allow_dummy=allow_dummy).K_max
    if not allow_dummy:
        dummy = VCMStreamReceiver(RxConfig(**KW), n_channels=C,
                                  fec_lanes=8, device="cpu")
        assert p.K_max < dummy.K_max
