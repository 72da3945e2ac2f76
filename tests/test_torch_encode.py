"""The port's ``DeviceEncoder`` against the host encoders and the JAX
``DeviceEncoder``, bit for bit (every comparison is exact).

Codes: short 1/2, short 3/5 and normal 1/2. The BCH matmul runs in float64,
so its result does not depend on the TF32 switches: the tests turn them on.
"""

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.ops import encode as jencode

from dvbs2rx_tpu_torch.ops import encode
from dvbs2rx_tpu_torch.ops.demap import quantize_llrs
from dvbs2rx_tpu_torch.rx.receiver import FECStage, RxConfig
from dvbs2rx_tpu_torch.spec.bch_spec import bch_encode_bytes
from dvbs2rx_tpu_torch.spec.fec_params import get_fec_info
from dvbs2rx_tpu_torch.spec.ldpc_tables import get_code

torch.set_num_threads(2)
CODES = [("short", "1/2"), ("short", "3/5"), ("normal", "1/2")]


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("frame_size,rate", CODES)
def test_device_encoder_matches_host_and_jax(tf32_on, frame_size, rate):
    fec = get_fec_info(frame_size, rate)
    code = get_code(fec.ldpc_table)
    enc = encode.get_device_encoder(frame_size, rate, device="cpu")
    assert enc is encode.get_device_encoder(frame_size, rate, "cpu")
    np.testing.assert_array_equal(
        encode.bch_parity_matrix(frame_size, fec.t, fec.kbch),
        jencode.bch_parity_matrix(frame_size, fec.t, fec.kbch))
    rng = np.random.default_rng(1)
    B = 5
    msgs = rng.integers(0, 2, (B, fec.kbch)).astype(np.uint8)
    msgs[0] = 1                      # the largest GF(2) sums: every bit set
    msgs[1] = 0

    cw_bch = enc.bch_encode_lane_major(torch.from_numpy(msgs.T.copy()))
    cw_bch = cw_bch.numpy().T
    assert cw_bch.shape == (B, fec.nbch) and cw_bch.dtype == np.uint8
    for i in range(B):
        par_ref = np.unpackbits(
            bch_encode_bytes(np.packbits(msgs[i]), frame_size, fec.t))
        np.testing.assert_array_equal(cw_bch[i, fec.kbch:], par_ref)
        np.testing.assert_array_equal(cw_bch[i, : fec.kbch], msgs[i])

    cw = enc(msgs.T.copy())
    assert cw.shape == (fec.nldpc, B) and cw.dtype == torch.uint8
    cw = cw.numpy().T
    np.testing.assert_array_equal(cw, code.encode(cw_bch))
    jenc = jencode.get_device_encoder(frame_size, rate)
    np.testing.assert_array_equal(cw, np.asarray(jenc(msgs.T.copy())).T)


def test_check_index_is_the_rolls_of_the_jax_encoder():
    """The gather table names, for each check sum, the data bits the JAX
    encoder's ``jnp.roll`` XORs bring there (zero padding at index K)."""
    code = get_code(get_fec_info("short", "1/2").ldpc_table)
    idx = encode.ldpc_check_index(code)
    assert idx.shape[0] == code.N - code.K
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2, (code.K, 2)).astype(np.uint8)
    blocks = data.astype(np.int32).reshape(code.n_blocks, code.M, 2)
    acc = np.zeros((code.M, code.q, 2), np.int32)
    for b, addrs in enumerate(code.block_addr):
        for x in addrs.tolist():
            acc[:, x % code.q] ^= np.roll(blocks[b], x // code.q, axis=0)
    ext = np.concatenate([data, np.zeros((1, 2), np.uint8)])
    got = ext[idx].sum(1) & 1
    np.testing.assert_array_equal(got, acc.reshape(-1, 2))


def test_device_encoder_roundtrip_through_fec_stage():
    """Encoded noisy codewords decode cleanly through the port's lane-major
    FEC stage (encode and decode agree on every structural convention)."""
    cfg = RxConfig(modcod="qpsk1/2", frame_size="short", fec_batch=6)
    stage = FECStage(cfg, "cpu")
    enc = encode.get_device_encoder("short", "1/2", device="cpu")
    rng = np.random.default_rng(2)
    msgs = rng.integers(0, 2, (6, cfg.fec.kbch)).astype(np.uint8)
    cw_t = enc(msgs.T.copy()).numpy()                          # (N, B)
    vals = 12.0 * (1.0 - 2.0 * cw_t.astype(np.float32))
    vals += rng.normal(0, 6.0, vals.shape).astype(np.float32)
    llrsT = quantize_llrs(torch.from_numpy(vals))
    kbytes, n_corr, _it, _ok, _h = stage.lane_major(llrsT)
    assert (n_corr >= 0).all()
    np.testing.assert_array_equal(kbytes.numpy(), np.packbits(msgs, axis=1))


def test_device_encoder_accepts_other_bit_dtypes():
    enc = encode.get_device_encoder("short", "1/2", device="cpu")
    rng = np.random.default_rng(4)
    msgs = rng.integers(0, 2, (enc.fec.kbch, 3))
    np.testing.assert_array_equal(enc(msgs).numpy(),
                                  enc(msgs.astype(np.uint8)).numpy())
    np.testing.assert_array_equal(
        enc(torch.from_numpy(msgs.astype(np.int8))).numpy(),
        enc(msgs.astype(np.uint8)).numpy())
