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


def _item_windows(plan, C, S, seg_len, L, sps, base_seg, off_bound, n):
    """Each work item's window in the kernel's arithmetic, item order:
    (c, s, k0, cnt, first, end, aligned). Outputs k0 .. k0+cnt-1 of
    segment s read samples [first, end) of row c; the fetch starts at
    ``aligned``, first rounded down to an even sample of the whole (C, n)
    tensor (16 bytes, for a 16-byte-aligned tensor)."""
    it = torch.arange(plan.items)
    c = it // (S * plan.n_chunks)
    s = it // plan.n_chunks % S
    k0 = it % plan.n_chunks * plan.chunk
    cnt = torch.clamp(seg_len - k0, max=plan.chunk)
    off = base_seg.to(torch.int64).clamp(0, off_bound)[c, s]
    first = s * seg_len * sps + off + sps * k0
    end = first + sps * (cnt - 1) + L
    aligned = first - (c * n + first) % 2
    return c, s, k0, cnt, first, end, aligned


# (C, S, seg_len, L, sps): the main path, ragged and tiny segments, one
# segment, the longest filter, the generic sps
PLAN_SHAPES = [
    (64, 15, 4332, 21, 2),
    (64, 16, 2048, 21, 2),      # the bench's front end (32,768 symbols)
    (3, 15, 333, 21, 2),
    (2, 4, 1025, 37, 2),
    (2, 3, 7, 21, 2),
    (2, 1, 1000, 64, 2),
    (3, 2, fir_cuda.CHUNK_MAX, 24, 2),
    (2, 5, 999, 21, 3),
    (1, 2, 2500, 64, 5),
]


@pytest.mark.parametrize("C,S,seg_len,L,sps", PLAN_SHAPES)
def test_launch_plan_covers_every_output_once(C, S, seg_len, L, sps):
    plan = fir_cuda.launch_plan(C, S, seg_len, L, sps)
    assert 0 < plan.chunk <= fir_cuda.CHUNK_MAX and plan.chunk % 2 == 0
    c, s, k0, cnt, *_ = _item_windows(plan, C, S, seg_len, L, sps,
                                      torch.zeros(C, S), 0, 1)
    assert bool((cnt > 0).all())
    hits = torch.zeros(C, S * seg_len, dtype=torch.int64)
    for ci, si, ki, ni in zip(c.tolist(), s.tolist(), k0.tolist(),
                              cnt.tolist()):
        hits[ci, si * seg_len + ki: si * seg_len + ki + ni] += 1
    assert bool((hits == 1).all())


@pytest.mark.parametrize("odd", [0, 1])
@pytest.mark.parametrize("C,S,seg_len,L,sps", PLAN_SHAPES)
def test_launch_plan_windows_fit_input_and_stage(C, S, seg_len, L, sps, odd):
    """At the shortest history the wrapper accepts (and one sample more, so
    that rows start off a 16-byte boundary), every window lies inside its
    row, the aligned fetch starts at most one sample early, and the
    window, shifted by that sample, fits one ring stage."""
    off_bound = 23
    n = (S * seg_len - 1) * sps + L + off_bound + odd
    plan = fir_cuda.launch_plan(C, S, seg_len, L, sps)
    rng = np.random.default_rng(seg_len)
    base = torch.from_numpy(rng.integers(-5, off_bound + 6, (C, S)))
    base[0, -1] = off_bound + 9                # the clip at the last window
    *_, first, end, aligned = _item_windows(plan, C, S, seg_len, L, sps,
                                            base, off_bound, n)
    assert bool((first >= 0).all()) and bool((end <= n).all())
    assert bool(((first - aligned >= 0) & (first - aligned <= 1)).all())
    assert int(end.max()) == n - odd
    assert bool(((end - aligned + 1) // 2 <= plan.stage_vectors).all())


@pytest.mark.parametrize("C,S,seg_len,L,sps", PLAN_SHAPES)
def test_launch_plan_ring_fits_shared_memory(C, S, seg_len, L, sps):
    plan = fir_cuda.launch_plan(C, S, seg_len, L, sps)
    assert plan.lmax >= L and plan.lmax % 4 == 0
    assert plan.smem_bytes <= fir_cuda.SMEM_LIMIT
    # the whole chunk's window of the widest item, with the shift, fits
    need = (1 + sps * (fir_cuda.CHUNK_MAX - 1) + plan.lmax + 1) // 2
    assert plan.stage_vectors >= need


def test_launch_plan_at_the_main_path_shape():
    """64 channels x 15 segments x 4,332 symbols, 21 taps, sps 2: five
    chunks of 868 per segment and a ring under the 48 KB that needs no
    opt-in."""
    plan = fir_cuda.launch_plan(64, 15, 4332, 21, 2)
    assert (plan.lmax, plan.chunk, plan.n_chunks, plan.items) == \
        (24, 868, 5, 4800)
    assert plan.smem_bytes == 46_688 < 48 * 1024


def test_launch_plan_at_the_bench_front_end_shape():
    """``FeedForwardSync.step_batched`` at the bench's 32,768-symbol
    block: 64 channels x 16 segments x 2,048 symbols, 21 taps (bucket 24),
    two whole chunks of 1,024 per segment."""
    plan = fir_cuda.launch_plan(64, 16, 2048, 21, 2)
    assert (plan.lmax, plan.chunk, plan.n_chunks, plan.items) == \
        (24, 1024, 2, 2048)
    assert plan.smem_bytes == 46_688 < 48 * 1024


@pytest.mark.parametrize("L,sps", [(65, 2), (21, 0), (21, 13)])
def test_launch_plan_rejects_what_the_kernel_cannot_take(L, sps):
    with pytest.raises(ValueError):
        fir_cuda.launch_plan(2, 3, 100, L, sps)
