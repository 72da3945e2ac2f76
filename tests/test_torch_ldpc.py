"""The port's plain LDPC decoder against the JAX decoders.

Held bit for bit (hard bits, final LLRs, batch iterations, per-frame
convergence) against ``LDPCDecoder`` (the XLA roll-based decoder) and
``PallasLDPCDecoder`` in interpret mode, run as ``tests/test_ldpc_pallas.py``
runs them, through both ``__call__`` and ``decode_lane_major``. The CUDA
kernel is held to this plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Codes: S2_C1 (variable degree) and S2_C4 (short rate 1/2, where 8 layers
name a block twice) against the XLA decoder; S2_C1 against the Pallas
interpreter. Inputs: random LLRs (no convergence, saturating) and encoded
codewords with 2% sign flips (early exit), B = 8.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops.ldpc import LDPCDecoder as JLDPCDecoder
from dvbs2rx_tpu.ops.ldpc_pallas import PallasLDPCDecoder
from dvbs2rx_tpu.spec.ldpc_tables import get_code

from dvbs2rx_tpu_torch.ops import ldpc_cuda
from dvbs2rx_tpu_torch.ops.ldpc import LDPCDecoder, write_runs, layer_edges

torch.set_num_threads(2)
B = 8


def _random(code, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-25, 25, (B, code.N), dtype=np.int8)


def _converging(code, seed=5):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, code.K), dtype=np.uint8)
    cw = code.encode(bits)
    llrs = np.where(cw == 0, 14, -14).astype(np.int8)
    flip = rng.random((B, code.N)) < 0.02
    return np.where(flip, -llrs, llrs).astype(np.int8)


def _assert_same(got, want):
    h1, l1, it1, c1 = [np.asarray(x) for x in got]
    h0, l0, it0, c0 = [np.asarray(x) for x in want]
    assert int(it1) == int(it0)
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_array_equal(h1, h0)
    np.testing.assert_array_equal(l1, l0)


CASES = [("S2_C1", "random", 4), ("S2_C1", "converging", 10),
         ("S2_C4", "random", 4), ("S2_C4", "converging", 10)]


@pytest.mark.parametrize("table,kind,trials", CASES)
def test_plain_matches_xla_decoder(table, kind, trials):
    code = get_code(table)
    llrs = _random(code) if kind == "random" else _converging(code)
    ref = JLDPCDecoder(code, max_trials=trials)
    port = LDPCDecoder(code, max_trials=trials, device="cpu")
    want = ref(llrs)
    _assert_same([x.numpy() for x in port(torch.from_numpy(llrs))], want)
    want_t = ref.decode_lane_major(np.ascontiguousarray(llrs.T))
    got_t = port.decode_lane_major(torch.from_numpy(np.ascontiguousarray(llrs.T)))
    _assert_same([x.numpy() for x in got_t], want_t)
    if kind == "converging":
        assert bool(np.all(np.asarray(want[3]))) and int(want[2]) < trials


@pytest.mark.parametrize("kind,trials", [("random", 4), ("converging", 10)])
def test_plain_matches_pallas_interpreter(kind, trials):
    code = get_code("S2_C1")
    llrs = _random(code) if kind == "random" else _converging(code)
    ker = PallasLDPCDecoder(code, max_trials=trials, interpret=True)
    port = LDPCDecoder(code, max_trials=trials, device="cpu")
    _assert_same([x.numpy() for x in port(torch.from_numpy(llrs))], ker(llrs))
    want_t = ker.decode_lane_major(np.ascontiguousarray(llrs.T))
    got_t = port.decode_lane_major(torch.from_numpy(np.ascontiguousarray(llrs.T)))
    _assert_same([x.numpy() for x in got_t], want_t)


def test_cuda_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor goes to the plain decoder and launches nothing."""
    code = get_code("S2_C4")
    llrs = torch.from_numpy(_converging(code))
    before = ldpc_cuda.LAUNCHES
    got = ldpc_cuda.CudaLDPCDecoder(code, 10, "cpu")(llrs)
    _assert_same([x.numpy() for x in got],
                 [x.numpy() for x in LDPCDecoder(code, 10, "cpu")(llrs)])
    assert ldpc_cuda.LAUNCHES == before


@pytest.mark.parametrize("table", ["S2_C4", "S2_B4"])
def test_kernel_tables_mark_repeated_blocks(table):
    """The kernel's barrier flags sit exactly on edges whose block an
    earlier edge of the same layer names (8 layers in both codes)."""
    code = get_code(table)
    ptr, base, shift, sync = ldpc_cuda.kernel_tables(code)
    edges = layer_edges(code)
    assert ptr[-1] == len(base) == sum(len(e) for e in edges)
    layers_with_repeats = 0
    for i, e in enumerate(edges):
        blocks = [b for b, _ in e]
        want = [int(b in blocks[:c]) for c, b in enumerate(blocks)]
        np.testing.assert_array_equal(sync[ptr[i]: ptr[i + 1]], want)
        layers_with_repeats += any(want)
        assert len(write_runs(e)) == 1 + sum(want)
    assert layers_with_repeats == 8

