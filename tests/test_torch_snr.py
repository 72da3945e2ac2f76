"""The post-decoder SNR refinement's wrapper (``ops/snr_cuda.py``) on the
CPU: what it decides and passes to ``csrc/snr_refine.cu``, and the routing
of ``rx.receiver._snr_refine_frames``.

- ``layout`` and ``plan`` from the bits' strides and the batch's shape: the
  stream step's view of lane-major bits, the LDPC kernel's rows, a slice,
  one frame;
- ``tables``: the points are the constellation's, and the column order
  the kernel decodes from ``order_code`` builds the same symbol indices as
  the plain re-map, for every interleaver rule;
- the kernel's arithmetic mirrored in numpy (its tiles, each lane's sums in
  order, the tile partials added in tile order) within rtol 1e-5 of the
  plain version, which is held to the JAX ``_snr_refine_frames``;
- CPU tensors take the plain body unchanged: ``_snr_refine_frames`` and
  ``_snr_refine_n0`` never call the wrapper, which refuses CPU tensors.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbs2rx_tpu.rx.receiver import _snr_refine_frames as j_snr_refine

from dvbs2rx_tpu_torch.ops import snr_cuda
from dvbs2rx_tpu_torch.rx import receiver
from dvbs2rx_tpu_torch.rx.receiver import _snr_refine_frames, _snr_refine_n0
from dvbs2rx_tpu_torch.spec.constellations import (
    BITS_PER_SYMBOL,
    constellation_points,
)
from dvbs2rx_tpu_torch.spec.interleaver import column_order

MODCODS = (("QPSK", "1/2"), ("8PSK", "3/5"), ("8PSK", "2/3"),
           ("8PSK", "8/15"), ("16APSK", "2/3"), ("32APSK", "3/4"))
SNR_RTOL = 1e-5     # float32 sums in another order than the plain version's


def _frames(constellation, rate, B, rows, R, seed, noise=0.3):
    """Random 0/1 bits (B, rows n_mod) and the frames' first R symbols:
    their points (the plain re-map) plus noise, (B, R, 2) float32."""
    rng = np.random.default_rng(seed)
    n_mod = BITS_PER_SYMBOL[constellation]
    bits = rng.integers(0, 2, (B, rows * n_mod)).astype(np.uint8)
    pts = constellation_points(constellation, rate)
    ref = pts[_plain_indices(bits, constellation, rate)][:, :R]
    x = ref + noise * (rng.normal(size=ref.shape)
                       + 1j * rng.normal(size=ref.shape))
    x = np.stack([x.real, x.imag], -1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(bits)


def _plain_indices(bits, constellation, rate):
    """The plain version's symbol indices (B, rows), from the bits."""
    n_mod = BITS_PER_SYMBOL[constellation]
    order = column_order(constellation, rate)
    B, rows = bits.shape[0], bits.shape[1] // n_mod
    b = bits.astype(np.int64)
    if order is None:
        sym = b.reshape(B, rows, n_mod)
    else:
        sym = np.stack([b.reshape(B, n_mod, rows)[:, c] for c in order], -1)
    idx = np.zeros((B, rows), np.int64)
    for k in range(n_mod):
        idx = (idx << 1) | sym[..., k]
    return idx


def _kernel_indices(bits, n_mod, code, R):
    """csrc/snr_refine.cu's sym_index over rows r < R, at the offsets and
    the row step its launcher decodes from the order code (unit bit
    stride)."""
    rows = bits.shape[1] // n_mod
    step = n_mod if code < 0 else 1
    off = [k if code < 0 else ((code >> (3 * k)) & 7) * rows
           for k in range(n_mod)]
    r = np.arange(R)
    idx = np.zeros((bits.shape[0], R), np.int64)
    for k in range(n_mod):
        idx = (idx << 1) | (bits[:, r * step + off[k]] & 1)
    return idx


def _kernel_mirror(x, bits, constellation, rate):
    """The kernel's sums in its order: per (row tile, frame) each lane adds
    its rows lane + 32 j in j order, the lanes by the xor butterfly; the
    last block adds the tiles' partials, lane t the tiles t, t + 32, ...,
    by the same butterfly; then the clamped ratio. float32 throughout."""
    n_mod = BITS_PER_SYMBOL[constellation]
    pts, code = snr_cuda.tables(constellation, rate)
    B, R, _ = x.shape
    idx = _kernel_indices(bits, n_mod, code, R)
    ref = pts[idx]                                            # (B, R, 2)
    e = x - ref
    one = (ref[..., 0] * ref[..., 0] + ref[..., 1] * ref[..., 1],
           e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1])
    tiles_r, _ = snr_cuda.plan(B, R)
    out = []
    for terms in one:
        part = np.zeros((tiles_r, B), np.float32)
        for t in range(tiles_r):
            lanes = np.zeros((32, B), np.float32)
            for j in range(snr_cuda.ROW_TILE // 32):
                r = t * snr_cuda.ROW_TILE + np.arange(32) + 32 * j
                ok = r < R
                lanes[ok] += terms[:, r[ok]].T
            part[t] = _butterfly(lanes)
        lanes = np.zeros((32, B), np.float32)
        for t in range(tiles_r):
            lanes[t % 32] += part[t]
        out.append(_butterfly(lanes))
    sp, np_ = out
    return sp / np.maximum(np_, np.float32(1e-12))


def _butterfly(lanes):
    """Lane 0's value after the xor shuffles 16, 8, 4, 2, 1."""
    v = lanes.copy()
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return v[0]


def test_layout_follows_the_unit_stride_axis():
    lane_major = torch.zeros((64800, 128), dtype=torch.uint8)
    assert snr_cuda.layout(lane_major[:, ::2].t()) == "lanes"
    rows = torch.zeros((128, 64800), dtype=torch.uint8)
    assert snr_cuda.layout(rows) == "rows"
    assert snr_cuda.layout(rows.t().t()[::2]) == "rows"   # the CCM step's
    assert snr_cuda.layout(rows[:, :16200]) == "rows"
    assert snr_cuda.layout(lane_major[:, :1].t()) == "rows"  # one frame
    assert snr_cuda.layout(lane_major[:, :37].t()) == "lanes"


@pytest.mark.parametrize("B,R,want", [
    (64, 32400, (127, 8)),       # the CCM step
    (128, 4096, (16, 16)),       # a VCM batch's snapshot prefix
    (1, 32400, (127, 1)),        # a host receiver's frame
    (65, 256, (1, 9)),
    (3, 257, (2, 1)),
])
def test_plan_tiles_rows_and_frames(B, R, want):
    assert snr_cuda.plan(B, R) == want
    tiles_r, tiles_b = want
    assert (tiles_r - 1) * snr_cuda.ROW_TILE < R <= tiles_r * snr_cuda.ROW_TILE
    assert ((tiles_b - 1) * snr_cuda.FRAME_TILE < B
            <= tiles_b * snr_cuda.FRAME_TILE)


@pytest.mark.parametrize("constellation,rate", MODCODS)
def test_tables_give_the_plain_indices_and_points(constellation, rate):
    pts, code = snr_cuda.tables(constellation, rate)
    want = constellation_points(constellation, rate)
    assert pts.dtype == np.float32 and pts.shape == (len(want), 2)
    np.testing.assert_array_equal(pts[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(pts[:, 1], want.imag.astype(np.float32))
    order = column_order(constellation, rate)
    assert (code == -1) == (order is None)
    n_mod = BITS_PER_SYMBOL[constellation]
    rows = 90 * 7
    bits = np.random.default_rng(n_mod).integers(
        0, 2, (3, rows * n_mod)).astype(np.uint8)
    np.testing.assert_array_equal(
        _kernel_indices(bits, n_mod, code, rows),
        _plain_indices(bits, constellation, rate))


def test_order_code_packs_three_bits_a_column():
    assert snr_cuda.order_code(None) == -1
    assert snr_cuda.order_code((2, 1, 0)) == 2 | 1 << 3
    assert snr_cuda.order_code((0, 1, 2, 3, 4)) == sum(
        k << (3 * k) for k in range(5))


@pytest.mark.parametrize("constellation,rate", MODCODS)
@pytest.mark.parametrize("B,rows,R", [(3, 900, 900), (2, 1080, 600)])
def test_kernel_mirror_matches_plain_and_jax(constellation, rate, B, rows, R):
    x, bits = _frames(constellation, rate, B, rows, R, seed=B + rows)
    n_mod = BITS_PER_SYMBOL[constellation]
    got = _snr_refine_frames(x, bits, constellation, rate, n_mod).numpy()
    want = np.asarray(j_snr_refine(jnp.asarray(x.numpy()),
                                   jnp.asarray(bits.numpy()), constellation,
                                   rate, n_mod))
    np.testing.assert_allclose(got, want, rtol=SNR_RTOL)
    mirror = _kernel_mirror(x.numpy(), bits.numpy(), constellation, rate)
    np.testing.assert_allclose(mirror, got, rtol=SNR_RTOL)


def test_cpu_tensors_take_the_plain_body(monkeypatch):
    """Neither entry calls the wrapper on CPU tensors; ``_snr_refine_n0``
    is the stream step's former rule over ``_snr_refine_frames``."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA wrapper was called on the CPU")

    monkeypatch.setattr(snr_cuda, "snr_refine", refuse)
    x, bits = _frames("QPSK", "1/2", 4, 810, 810, seed=5)
    x[2] = 0.0                            # snr 1: refined
    bits[3] = 0                           # x on point 0: np 0, clamped
    x[3] = torch.from_numpy(snr_cuda.tables("QPSK", "1/2")[0][0])
    snr = _snr_refine_frames(x, bits, "QPSK", "1/2", 2)
    before = snr_cuda.LAUNCHES
    n0 = torch.tensor([0.0, 0.5, 0.25, 0.125], dtype=torch.float32)
    got_snr, got_n0 = _snr_refine_n0(x, bits, "QPSK", "1/2", 2, n0)
    assert snr_cuda.LAUNCHES == before
    assert torch.equal(got_snr, snr)
    assert torch.equal(got_n0, torch.where(snr > 0,
                                           1.0 / snr.clamp(min=1e-9), n0))
    assert float(snr[3]) > 1e6            # sp / 1e-12


def test_wrapper_refuses_cpu_tensors():
    x, bits = _frames("QPSK", "1/2", 1, 90, 90, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        snr_cuda.snr_refine(x, bits, "QPSK", "1/2", 2)


def test_counter_is_registered():
    from dvbs2rx_tpu_torch import _build

    assert "snr_refine" in _build.launch_counts()
    assert "snr_refine_launch" in _build._SIGNATURES
    assert receiver.snr_cuda is snr_cuda
