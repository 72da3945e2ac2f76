"""Time-axis sharding of the port against the JAX package's.

The ports of ``tests/test_stream_shard.py``'s three tests: the port's
``sharded_timing_metric`` and ``sharded_matched_filter`` on a mesh of
``["cpu"] * D`` against the JAX functions on ``jax.devices()[:D]`` (the 8
virtual CPU devices of ``tests/conftest.py``) and against the unsharded
zero-history results, rtol 1e-4 (``test_torch_stream.py``'s float
tolerance; the metric's absolute floor 1e-5 as the JAX test's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvbs2rx_tpu.ops import cplx as jcplx
from dvbs2rx_tpu.parallel import stream_shard as jshard
from dvbs2rx_tpu.spec.rrc import polyphase_rrc_bank
from dvbs2rx_tpu_torch.ops import plsync
from dvbs2rx_tpu_torch.parallel import stream_shard

from tests.test_stream_shard import waveform  # noqa: F401  (fixture)

torch.set_num_threads(2)


def _meshes(n_dev):
    return (jshard.make_time_mesh(jax.devices()[:n_dev]),
            stream_shard.make_time_mesh(["cpu"] * n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_metric_matches_jax_and_unsharded(waveform, n_dev):
    jmesh, mesh = _meshes(n_dev)
    T = (waveform.size // n_dev) * n_dev
    sym = jcplx.from_np(waveform[:T])
    jgot = np.asarray(jshard.sharded_timing_metric(jmesh)(
        jshard.shard_time(jmesh, jnp.asarray(sym))))
    parts = stream_shard.sharded_timing_metric(mesh)(
        stream_shard.shard_time(mesh, sym))
    assert len(parts) == n_dev and parts[0].shape == (T // n_dev,)
    got = mesh.gather(parts).numpy()
    ref = plsync.timing_metric(torch.from_numpy(sym),
                               torch.zeros((90, 2)))[0].numpy()
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_sharded_metric_finds_sofs(waveform):
    """Peaks of the sharded metric land on PLHEADER ends, even for frames
    straddling shard boundaries, at the same places as JAX's."""
    jmesh, mesh = _meshes(8)
    T = (waveform.size // 8) * 8
    sym = jcplx.from_np(waveform[:T])
    m = mesh.gather(stream_shard.sharded_timing_metric(mesh)(sym)).numpy()
    jm = np.asarray(jshard.sharded_timing_metric(jmesh)(
        jshard.shard_time(jmesh, jnp.asarray(sym))))
    L = 16200 // 2 + 90            # short QPSK PLFRAME, no pilots
    peaks = np.where(m > 25.0)[0]
    expect = np.arange(89, T, L)
    assert set(expect) <= set(peaks.tolist())
    assert len(peaks) <= len(expect) + 2
    np.testing.assert_array_equal(peaks, np.where(jm > 25.0)[0])


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matched_filter_matches_jax_and_unsharded(n_dev):
    jmesh, mesh = _meshes(n_dev)
    rng = np.random.default_rng(5)
    sps = 2
    T = 8 * 1024 * sps
    x = rng.normal(size=(T, 2)).astype(np.float32)
    bank, L, _delay = polyphase_rrc_bank(sps, 0.2, 5, 4)
    taps = bank[0]
    jy = np.asarray(jshard.sharded_matched_filter(jmesh, taps, sps=sps)(
        jshard.shard_time(jmesh, jnp.asarray(x))))
    parts = stream_shard.sharded_matched_filter(mesh, taps, sps=sps)(x)
    y = mesh.gather(parts).numpy()
    assert y.shape == (T // sps, 2)
    xz = np.concatenate([np.zeros((len(taps) - 1, 2), np.float32), x])
    ref = np.stack([
        (np.lib.stride_tricks.sliding_window_view(xz[:, r], len(taps))[::sps]
         .astype(np.float64) @ taps.astype(np.float64))
        for r in range(2)], axis=-1)
    np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5)


def test_time_mesh_needs_a_card_or_devices():
    mesh = stream_shard.make_time_mesh(["cpu"] * 4)
    assert mesh.shape == {"t": 4} and mesh.axis_names == ("t",)
    with pytest.raises(ValueError, match="divide"):
        stream_shard.shard_time(mesh, np.zeros((10, 2), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_shard.make_time_mesh()
