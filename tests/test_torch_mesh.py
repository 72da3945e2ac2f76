"""The port's channel mesh against the JAX package's.

The JAX side shards over ``jax.devices()[:D]``, the 8 virtual CPU devices
of ``tests/conftest.py``; the port's mesh is ``["cpu"] * D``.

- ``StreamReceiver(mesh=)`` at D = 2: the JAX receiver under its mesh is
  primed, its global state read out as numpy primes the port through
  ``put_state``, and both step: kbytes and integer statistics exact, float
  statistics within rtol 1e-4 (``test_torch_stream.py``'s tolerance), the
  state gathered back equal within the same tolerance. The port's sharded
  step, scan step, re-acquisition and engine equal its unsharded ones:
  kbytes, TS and integers bit for bit, floats within rtol 1e-6 (a shard's
  float32 reductions over C/D channels may round once differently from
  the same reductions over C).
- ``BatchedPipeline(mesh=)`` at D = 2 and 8 on ``tests/test_parallel.py``'s
  stimulus: equal to the unsharded port and to the JAX pipeline (kbytes
  exact, n0 within rtol 1e-4), and to the Tx's BBFRAMEs.
"""

import numpy as np
import pytest
import torch

import jax

from dvbs2rx_tpu.ops import cplx as jcplx
from dvbs2rx_tpu.parallel.batch import BatchedPipeline as JBatchedPipeline
from dvbs2rx_tpu.parallel.batch import make_channel_mesh as jmake_mesh
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig
from dvbs2rx_tpu.rx.stream import StreamReceiver as JStreamReceiver
from dvbs2rx_tpu_torch.convert import (
    sharded_state_from_numpy,
    sharded_state_to_numpy,
    state_to_numpy,
)
from dvbs2rx_tpu_torch.parallel.batch import (
    BatchedPipeline,
    make_channel_mesh,
    shard_channels,
)
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import StreamEngine, StreamReceiver

from tests.test_parallel import _stimulus as _pipe_stimulus
from tests.test_stream import _stimulus
from tests.test_torch_stream import EXACT, FLOAT_ATOL

torch.set_num_threads(2)

C, F, T, D = 2, 2, 3, 2
KW = dict(modcod="qpsk1/2", frame_size="short", sym_sync_impl="ffw",
          fec_batch=C * F)


def _blocks(sr, iq, n):
    return [jcplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                             sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
            for t in range(n)]


@pytest.fixture(scope="module")
def ccm():
    mesh = make_channel_mesh(["cpu"] * D)
    sr = StreamReceiver(RxConfig(**KW), n_channels=C, frames_per_step=F,
                        mesh=mesh)
    plain = StreamReceiver(RxConfig(**KW), n_channels=C, frames_per_step=F,
                           device="cpu")
    iq, _ = _stimulus(sr, T, seed=4)
    return mesh, sr, plain, iq


def _assert_stats(stats, want, rtol=1e-4):
    """Integer statistics exact; floats within ``rtol`` (1e-4 against JAX
    with FLOAT_ATOL's floors, 1e-6 between the port's own forms)."""
    for k in EXACT:
        np.testing.assert_array_equal(np.asarray(stats[k]),
                                      np.asarray(want[k]), err_msg=k)
    for k, atol in FLOAT_ATOL.items():
        np.testing.assert_allclose(
            np.asarray(stats[k]), np.asarray(want[k]), rtol=rtol,
            atol=atol if rtol >= 1e-4 else 1e-9, err_msg=k)


def _assert_states(got, want):
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-9,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sharded_stream_matches_the_jax_mesh(ccm):
    mesh, sr, _, iq = ccm
    jsr = JStreamReceiver(JRxConfig(**KW), n_channels=C, frames_per_step=F,
                          mesh=jmake_mesh(jax.devices()[:D]))
    jstate = jsr.prime(iq[:, : jsr._n_fe])
    state = sr.put_state({k: np.asarray(v) for k, v in jstate.items()})
    assert len(state) == D
    assert all(st["sbuf"].shape[0] == C // D for st in state)
    for blk in _blocks(sr, iq, T):
        jstate, jkb, jstats = jsr.step(jstate, jsr.put_iq(blk))
        state, kb, stats = sr.step(state, blk)
        np.testing.assert_array_equal(kb.numpy(), np.asarray(jkb))
        _assert_stats(stats, jstats)
    assert int(stats["bch_errors"]) == 0 and bool(stats["locked"].all())
    back = sharded_state_to_numpy(state)
    for k, v in jstate.items():
        v = np.asarray(v)
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(back[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_sharded_stream_equals_the_unsharded_port(ccm):
    mesh, sr, plain, iq = ccm
    st_u = plain.prime(iq[:, : plain._n_fe])
    st_s = sr.prime(iq[:, : sr._n_fe])
    _assert_states(sharded_state_to_numpy(st_s), state_to_numpy(st_u))
    blks = _blocks(sr, iq, T)
    for blk in blks:
        st_u, kb_u, stats_u = plain.step(st_u, torch.from_numpy(blk))
        st_s, kb_s, stats_s = sr.step(st_s, blk)
        assert torch.equal(kb_s, kb_u)
        _assert_stats(stats_s, stats_u, rtol=1e-6)
    # the scan under the mesh: one chain per shard, merged as the step
    _, kbs, sstats = sr.make_scan_step(T)(sr.prime(iq[:, : sr._n_fe]),
                                          np.stack(blks))
    _, kbs_u, sstats_u = plain.make_scan_step(T)(
        plain.prime(iq[:, : plain._n_fe]), np.stack(blks))
    assert torch.equal(kbs, kbs_u)
    assert set(sstats) == set(sstats_u)
    _assert_stats(sstats, sstats_u, rtol=1e-6)
    # re-acquisition of channel 1 (shard 1) from the latest samples
    a = sr._n_fe + sr.n_in
    tail = torch.from_numpy(
        jcplx.from_np(iq[:, a: a + sr._n_fe]).astype(np.float32))
    mask = torch.tensor([False, True])
    new_u, ok_u = plain.reacquire(st_u, tail, mask)
    new_s, ok_s = sr.reacquire(st_s, tail, mask)
    assert ok_s.tolist() == ok_u.tolist() == [False, True]
    _assert_states(sharded_state_to_numpy(new_s), state_to_numpy(new_u))


def test_sharded_state_round_trip(ccm):
    mesh, sr, _, _ = ccm
    st = sr.init_state_np()
    st["fp"][:] = np.arange(C)
    parts = sharded_state_from_numpy(st, mesh)
    assert [int(p["fp"][0]) for p in parts] == list(range(0, C, C // D))
    back = sharded_state_to_numpy(parts)
    for k, v in st.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_sharded_engine_ts_equals_the_unsharded_engine(ccm):
    mesh, sr, _, iq = ccm
    n = sr._n_fe + T * sr.n_in
    engines = [StreamEngine(RxConfig(**KW), n_channels=C, frames_per_step=F,
                            device="cpu"),
               StreamEngine(RxConfig(**KW), n_channels=C, frames_per_step=F,
                            mesh=mesh)]
    try:
        outs = [e.receive(iq[:, :n]) for e in engines]
    finally:
        for e in engines:
            e.close()
    for c in range(C):
        assert outs[0][c].size >= 188 * 10
        np.testing.assert_array_equal(outs[1][c], outs[0][c])
    assert engines[1].stats.bch_frame_errors == 0
    assert engines[1].stats.bch_frames == engines[0].stats.bch_frames


def test_mesh_arguments_are_checked():
    mesh = make_channel_mesh(["cpu"] * 2)
    assert mesh.shape == {"ch": 2} and mesh.axis_names == ("ch",)
    with pytest.raises(ValueError, match="divisible"):
        StreamReceiver(RxConfig(**KW), n_channels=3, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        StreamReceiver(RxConfig(**KW), n_channels=2, mesh=mesh,
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_channel_mesh()


@pytest.fixture(scope="module")
def pipeline_case():
    jcfg = JRxConfig(modcod="qpsk1/2", frame_size="short", fec_batch=16)
    Cp, Fp = 8, 2
    syms, _, pkts = _pipe_stimulus(jcfg, Cp, Fp)
    jpipe = JBatchedPipeline(jcfg, n_channels=Cp, frames_per_step=Fp)
    h, p = jpipe.frame_inputs_from_symbols(syms)
    jkb, jn0, jst = jpipe.step(h, p, True)
    from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig

    ref = Transmitter(TxConfig(modcod="qpsk1/2", frame_size="short")
                      ).bbframes(pkts.reshape(-1))[:Fp]
    return (Cp, Fp, h, p, (np.asarray(jkb), np.asarray(jn0),
                           {k: np.asarray(v) for k, v in jst.items()}), ref)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_pipeline_matches_unsharded_and_jax(pipeline_case, n_dev):
    Cp, Fp, h, p, (jkb, jn0, jst), ref = pipeline_case
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", fec_batch=16)
    plain = BatchedPipeline(cfg, Cp, Fp, device="cpu")
    kb0, n00, st0 = plain.step(h, p, True)
    mesh = make_channel_mesh(["cpu"] * n_dev)
    sharded = BatchedPipeline(cfg, Cp, Fp, mesh=mesh)
    hs, ps = shard_channels(mesh, h), shard_channels(mesh, p)
    assert len(hs) == n_dev and hs[0].shape == (91, 2, Cp // n_dev, Fp + 1)
    kb1, n01, st1 = sharded.step(hs, ps, True)
    assert torch.equal(kb1, kb0) and torch.equal(n01, n00)
    for k in st0:
        assert torch.equal(st1[k], st0[k]), k
    # global numpy inputs are split by the pipeline itself
    kb2, _, _ = sharded.step(h, p, True)
    assert torch.equal(kb2, kb0)
    np.testing.assert_array_equal(kb1.numpy(), jkb)
    np.testing.assert_allclose(n01.numpy(), jn0, rtol=1e-4)
    assert int(st1["bch_errors"]) == int(jst["bch_errors"]) == 0
    assert int(st1["ldpc_iters"]) == int(jst["ldpc_iters"])
    np.testing.assert_allclose(float(st1["metric_min"]),
                               float(jst["metric_min"]), rtol=1e-4)
    np.testing.assert_array_equal(kb1.numpy()[0], ref)
