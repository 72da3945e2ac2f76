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

The kernel's compressed check messages (``pack_layer_msgs`` /
``unpack_layer_msgs``) are checked with hypothesis against the plain
check-node rule, and a plain decode whose message store goes through the
packed words must match the unmodified plain decoder bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dvbs2rx_tpu.ops.ldpc import LDPCDecoder as JLDPCDecoder
from dvbs2rx_tpu.ops.ldpc_pallas import PallasLDPCDecoder
from dvbs2rx_tpu.spec.ldpc_tables import available_tables, get_code

from dvbs2rx_tpu_torch.ops import ldpc_cuda
from dvbs2rx_tpu_torch.ops.ldpc import (
    LDPCDecoder,
    check_node,
    edge_rows,
    layer_edges,
    msg_layout,
    pack_layer_msgs,
    unpack_layer_msgs,
    write_runs,
)

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


TABLES = available_tables()
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


def _kernel_shapes():
    """The (largest data degree, variable degrees) pairs the CUDA kernel is
    instantiated for (``LDPC_CODE_SHAPES`` in ``csrc/ldpc_layered.cu``)."""
    src = (Path(ldpc_cuda.__file__).parent.parent / "csrc"
           / "ldpc_layered.cu").read_text()
    body = src.split("#define LDPC_CODE_SHAPES(X)", 1)[1].split("\n\n", 1)[0]
    return {(int(d), v == "true")
            for d, v in re.findall(r"X\((\d+), (true|false)\)", body)}


@pytest.mark.parametrize("table", TABLES)
def test_packed_tables_and_one_writer_per_variable(table):
    """The kernel's packed tables decode to the layer edges, every code's
    shared memory fits one CTA, its shape -- the wrapper's (dm, var) -- is
    one the kernel library instantiates (so a new table fails here, not
    on the card), and a layer without a repeated block touches each
    variable from exactly one (row, edge): the kernel drops its read/write
    barrier there."""
    code = get_code(table)
    ker = ldpc_cuda.CudaLDPCDecoder(code, 4, "cpu")
    assert (ker.dm, ker.var) in _kernel_shapes()
    edges = layer_edges(code)
    tab = ldpc_cuda.packed_tables(code).astype(np.int64)
    q, n_edges = code.q, sum(len(e) for e in edges)
    dm = max(len(e) for e in edges)
    n_tab = (2 * q + n_edges + dm + 3) & ~3      # the kernel's table_ints
    assert tab.size == n_tab and not tab[2 * q + n_edges:].any()
    _, _, nbytes = msg_layout(dm + 2)
    assert q * 360 * nbytes + 4 * n_tab + code.N <= 232448
    for i, e in enumerate(edges):
        e0, D, lsync = tab[i] & 0xFFFF, (tab[i] >> 16) & 0xFF, tab[i] >> 24
        assert D == len(e)
        blocks = [b for b, _ in e]
        want = [int(b in blocks[:c]) for c, b in enumerate(blocks)]
        assert tab[q + i] == sum(w << c for c, w in enumerate(want))
        assert lsync == int(any(want))
        for c, (b, sh) in enumerate(e):
            t = tab[2 * q + e0 + c]
            assert (t & 0xFFFF, t >> 16) == (b * 360, sh)
        rows = edge_rows(code, i, edges).reshape(-1).tolist()
        if i == 0:
            rows.pop(len(rows) - 360)          # the dead edge of row 0
        assert (len(set(rows)) == len(rows)) == (lsync == 0), i


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



# values that make ties at the minimum, magnitudes at and above the
# message clip (32) and saturated inputs likely
_EDGE_VALUES = st.one_of(
    st.sampled_from([-128, -127, -40, -34, -33, -32, -31, -3, -2, -1, 0, 1,
                     2, 3, 31, 32, 33, 34, 40, 127]),
    st.integers(-128, 127),
)


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_packed_messages_unpack_to_the_stored_messages(data):
    E = data.draw(st.integers(3, 32), label="E")
    max_deg = data.draw(st.integers(E, 32), label="max_deg")
    rows = 3
    vals = data.draw(st.lists(_EDGE_VALUES, min_size=E * rows,
                              max_size=E * rows), label="inputs")
    inp = torch.tensor(vals, dtype=torch.int32).reshape(E, rows)
    dead_row = data.draw(st.booleans(), label="dead edge in row 0")
    if dead_row:
        inp[E - 1, 0] = 127                  # the layer-0 dead edge's input
    want = check_node(inp).clamp(-32, 31)
    dead = None
    if dead_row:
        want[E - 1, 0] = 0
        dead = torch.tensor([True, False, False])
    words = pack_layer_msgs(inp, max_deg)
    _, ib, nbytes = msg_layout(max_deg)
    assert int(words.max()) < (1 << (8 * nbytes))
    assert int(words.max()) < (1 << (12 + ib + E))
    got = unpack_layer_msgs(words, E, dead, max_deg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_packed_messages_ties_and_large_magnitudes():
    # columns: a tie at min0 (two edges), all magnitudes above 32, a single
    # zero input, and min1 exactly 32 with mixed signs
    inp = torch.tensor([[5, 100, 0, -40, 9],
                        [-5, -90, 7, 33, -9],
                        [6, 127, -7, 34, 9],
                        [50, -128, 7, -60, -9]], dtype=torch.int32)
    want = check_node(inp).clamp(-32, 31)
    got = unpack_layer_msgs(pack_layer_msgs(inp), 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want.abs().max()) == 32 and int(want.max()) == 31


class _PackedStoreDecoder(LDPCDecoder):
    """The plain decoder with its message store kept as packed words: after
    each layer's update, the layer's messages are replaced by the unpacked
    words of its check-node inputs (formed here as the update forms them,
    before it writes the state)."""

    stores = 0

    def _update_layer(self, i, st, msgs, first, active):
        rows = self._rows[i]
        E = rows.shape[0]
        vals = st[rows]
        inp = (vals if first else vals - msgs[i, :E]).clamp(-128, 127)
        dead = None
        if i == 0:
            inp[E - 1, 0] = 127
            dead = torch.zeros(inp.shape[1:], dtype=torch.bool)
            dead[0] = True
        super()._update_layer(i, st, msgs, first, active)
        words = pack_layer_msgs(inp, self.max_deg)
        msgs[i, :E] = unpack_layer_msgs(words, E, dead, self.max_deg)
        self.stores += 1


@pytest.mark.parametrize("table,kind,trials,batch", [
    ("S2_C4", "random", 4, 4), ("S2_C4", "converging", 10, 4),
    ("S2_B4", "converging", 10, 2),
])
def test_plain_decoder_with_packed_store_is_bit_exact(table, kind, trials,
                                                      batch):
    code = get_code(table)
    llrs = (_random(code) if kind == "random" else _converging(code))[:batch]
    x = torch.from_numpy(llrs)
    packed = _PackedStoreDecoder(code, max_trials=trials, device="cpu")
    got = [t.numpy() for t in packed(x)]
    want = [t.numpy() for t in LDPCDecoder(code, trials, "cpu")(x)]
    _assert_same(got, want)
    assert packed.stores >= code.q * max(1, int(want[2]))
