"""The port's matched filter (plain version of the CUDA kernel) against JAX.

``fir_cuda.mf_segmented`` on CPU tensors runs ``mf_segmented_plain``; it is
held to the JAX ``pallas_fir.mf_segmented`` XLA path (``use_pallas=False``,
``precision="highest"``), with ``base_seg`` values outside [0, off_bound]
that both sides must clip identically, and to the Pallas kernel in the
interpreter at a tiling shape (seg_len = 2048). Tolerance: 1e-5 absolute on
unit-variance inputs with 21 taps (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvbs2rx_tpu.ops.pallas_fir import mf_decimate as j_mf_decimate
from dvbs2rx_tpu.ops.pallas_fir import mf_segmented as j_mf_segmented

from dvbs2rx_tpu_torch.ops import fir_cuda

torch.set_num_threads(2)
SPS, L, OFF = 2, 21, 23
TOL = 1e-5


def _inputs(C, S, seg_len, seed, lo=-4, hi=OFF + 6):
    rng = np.random.default_rng(seed)
    n = (S * seg_len - 1) * SPS + L + OFF + 5
    x = rng.normal(size=(C, n, 2)).astype(np.float32)
    taps = (rng.normal(size=(C, S, L)) / np.sqrt(L)).astype(np.float32)
    base = rng.integers(lo, hi, (C, S)).astype(np.int32)
    return x, taps, base


def _port(x, taps, base, seg_len):
    before = fir_cuda.LAUNCHES
    y = fir_cuda.mf_segmented(torch.from_numpy(x), torch.from_numpy(taps),
                              torch.from_numpy(base), SPS, seg_len, OFF)
    assert fir_cuda.LAUNCHES == before          # CPU tensors: plain version
    return y.numpy()


@pytest.mark.parametrize("C,S,seg_len,seed", [(3, 15, 44, 0), (2, 4, 301, 1)])
def test_plain_matches_xla_path_with_offset_clip(C, S, seg_len, seed):
    x, taps, base = _inputs(C, S, seg_len, seed)
    assert (base < 0).any() and (base > OFF).any()
    want = np.asarray(j_mf_segmented(
        jnp.asarray(x), jnp.asarray(taps), jnp.asarray(base), SPS, seg_len,
        OFF, use_pallas=False, precision="highest"))
    got = _port(x, taps, base, seg_len)
    assert got.shape == want.shape == (C, S * seg_len, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_plain_matches_pallas_interpreter_at_tile_shape():
    C, S, seg_len = 2, 2, 2048
    x, taps, base = _inputs(C, S, seg_len, 7, lo=0, hi=OFF + 1)
    x = np.concatenate([x, np.zeros((C, 140, 2), np.float32)], axis=1)
    want = np.asarray(j_mf_segmented(
        jnp.asarray(x), jnp.asarray(taps), jnp.asarray(base), SPS, seg_len,
        OFF, use_pallas=True, interpret=True))
    got = _port(x, taps, base, seg_len)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_decimate_matches_xla_path():
    rng = np.random.default_rng(3)
    n_out, n = 500, 1100
    x = rng.normal(size=(n, 2)).astype(np.float32)
    taps = (rng.normal(size=(L,)) / np.sqrt(L)).astype(np.float32)
    # the last is clipped into range by both sides
    for base in (0, 5, n - n_out * SPS - L + 1, n):
        want = np.asarray(j_mf_decimate(
            jnp.asarray(x), jnp.asarray(taps), jnp.int32(base), SPS, n_out,
            use_pallas=False, precision="highest"))
        got = fir_cuda.mf_decimate(
            torch.from_numpy(x)[None], torch.from_numpy(taps)[None],
            torch.tensor([base], dtype=torch.int32), SPS, n_out)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_short_history_raises():
    x, taps, base = _inputs(1, 2, 10, 0)
    with pytest.raises(ValueError, match="history too short"):
        fir_cuda.mf_segmented(torch.from_numpy(x[:, :-6]),
                              torch.from_numpy(taps), torch.from_numpy(base),
                              SPS, 10, OFF)

