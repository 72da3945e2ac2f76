"""The port's plain LDPC decoder with the JAX decoder's other rules.

``ops/ldpc.LDPCDecoder`` implements offset-min-sum (the CUDA kernel's
rule), min-sum (beta 0), min-sum-c (the two-input min with a correction
term, in the reference's prefix/suffix order) and the self-corrected
message update; ``rx/receiver.get_ldpc_decoder`` sends every rule but the
default to it. Held bit for bit (hard bits, final LLRs, batch iterations,
per-frame convergence) against the JAX ``LDPCDecoder`` with the same rule,
in both layouts; the rules' building blocks on hand-checked values.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops.ldpc import LDPCDecoder as JLDPCDecoder
from dvbs2rx_tpu.spec.ldpc_tables import get_code

from dvbs2rx_tpu_torch.ops.ldpc import LDPCDecoder

from tests.test_torch_ldpc import _assert_same, _converging, _random

torch.set_num_threads(2)


# the JAX decoder's other check-node and message-store rules, which the
# port's plain decoder implements and the CUDA kernel does not
VARIANTS = [("min-sum", "normal"), ("min-sum-c", "normal"),
            ("offset-min-sum", "self-corrected"),
            ("min-sum-c", "self-corrected")]


@pytest.mark.parametrize("algo,update", VARIANTS)
def test_plain_variants_match_xla_decoder(algo, update):
    """Hard bits, final LLRs, iterations and convergence equal to the JAX
    decoder's with the same rule, on S2_C4 (a layer naming a block twice),
    in both layouts. One batch holds 4 random frames, which saturate
    (min-sum-c stores its messages in the full int8 range, with no +-32
    clamp) and never converge, and 4 codewords with 5% of their signs
    flipped, which the rules take by different paths; per-frame freezing
    keeps the frames independent."""
    code = get_code("S2_C4")
    rng = np.random.default_rng(11)
    conv = _converging(code)[4:]
    conv = np.where(rng.random(conv.shape) < 0.03, -conv, conv)
    llrs = np.concatenate([_random(code)[:4], conv]).astype(np.int8)
    ref = JLDPCDecoder(code, max_trials=6, algo=algo, update=update)
    port = LDPCDecoder(code, 6, "cpu", algo, update)
    want = ref(llrs)
    _assert_same([x.numpy() for x in port(torch.from_numpy(llrs))], want)
    got_t = port.decode_lane_major(torch.from_numpy(
        np.ascontiguousarray(llrs.T)))
    _assert_same([x.numpy().T if x.dim() == 2 else x.numpy() for x in got_t],
                 want)
    assert not np.asarray(want[3])[:4].any()


def test_variant_rules_reach_their_updates():
    """min-sum (beta 0) keeps magnitudes the offset rule reduces by one;
    minc's correction term moves a near-cancelling pair by +-1; the
    exclusive minc reduce of three edges combines the other two."""
    from dvbs2rx_tpu_torch.ops.ldpc import check_node, minc, minc_exclusive

    inp = torch.tensor([[3], [-5], [7]], dtype=torch.int32)
    assert check_node(inp, beta=0)[:, 0].tolist() == [-5, 3, -3]
    assert check_node(inp)[:, 0].tolist() == [-4, 2, -2]
    a = torch.tensor([3, 2, 9, 0], dtype=torch.int32)
    b = torch.tensor([-2, 2, 1, 5], dtype=torch.int32)
    # |a+b| = 1 < 4 and |a-b| = 5 > 2: +1 on -2; |a-b| = 0 < 4, |a+b| = 4
    # > 0: -1 on 2; far apart: plain min; a zero input: 0
    assert minc(a, b).tolist() == [-1, 1, 1, 0]
    out = minc_exclusive(torch.stack([a, b, b]))
    assert out[0].tolist() == minc(b, b).tolist()
    assert out[2].tolist() == minc(a, b).tolist()
