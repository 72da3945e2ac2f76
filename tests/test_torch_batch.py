"""The port's ``BatchedPipeline`` against the JAX ``BatchedPipeline``.

Same numpy-seeded, frame-aligned symbols (the port's transmitter, two
channels with their own noise and phase) through both pipelines' host
helpers and ``step``. Tolerances: ``channel_major_inputs`` and
``frame_inputs_from_symbols`` exact (numpy gathers); kbytes, ``bch_errors``
and ``ldpc_iters`` exact; n0 and ``metric_min`` within rtol 1e-5 (float32
reductions in another order; measured differences are a few ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbs2rx_tpu.parallel.batch import BatchedPipeline as JBatchedPipeline
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig

from dvbs2rx_tpu_torch.parallel.batch import BatchedPipeline
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.tx import Transmitter, TxConfig

torch.set_num_threads(2)
C, F = 2, 2
CASES = [  # (modcod, pilots, noise std per rail)
    ("qpsk1/2", False, 0.45),
    ("8psk3/5", True, 0.2),
]


def _symbols(modcod, pilots, std, seed):
    """(C, (F+1) L + 91) complex64 frame-aligned symbols, and each
    channel's BBFRAMEs as the transmitter scrambled them."""
    tx = Transmitter(TxConfig(modcod=modcod, frame_size="short",
                              pilots=pilots))
    L = tx.cfg.pls_info.plframe_len
    rng = np.random.default_rng(seed)
    syms, frames = [], []
    for _ in range(C):
        n_pkts = ((F + 2) * tx.df_bytes) // 188 + 2
        pkts = rng.integers(0, 256, (n_pkts, 188), dtype=np.uint8)
        pkts[:, 0] = 0x47
        t = Transmitter(tx.cfg)
        s = t.modulate_ts(pkts.reshape(-1))[: (F + 1) * L + 91]
        noise = rng.normal(0, std, s.shape + (2,))
        s = (s * np.exp(1j * rng.uniform(-0.3, 0.3))
             + noise[..., 0] + 1j * noise[..., 1])
        syms.append(s.astype(np.complex64))
        frames.append(Transmitter(tx.cfg).bbframes(pkts.reshape(-1))[:F])
    return np.stack(syms), np.stack(frames)


@pytest.mark.parametrize("modcod,pilots,std", CASES)
def test_batched_pipeline_matches_jax(modcod, pilots, std):
    kw = dict(modcod=modcod, frame_size="short", pilots=pilots, fec_batch=8)
    syms, frames = _symbols(modcod, pilots, std, seed=len(modcod) + pilots)
    ours = BatchedPipeline(RxConfig(**kw), C, F, device="cpu")
    ref = JBatchedPipeline(JRxConfig(**kw), n_channels=C, frames_per_step=F)
    assert (ours.frame_len, ours.payload_len) == (ref.frame_len,
                                                  ref.payload_len)
    for a, b in zip(ours.channel_major_inputs(syms),
                    ref.channel_major_inputs(syms)):
        np.testing.assert_array_equal(a, b)
    h, p = ours.frame_inputs_from_symbols(syms)
    hj, pj = ref.frame_inputs_from_symbols(syms)
    np.testing.assert_array_equal(h, hj)
    np.testing.assert_array_equal(p, pj)
    assert h.shape == (91, 2, C, F + 1) and p.shape == (ours.payload_len, 2,
                                                        C, F)

    kb, n0, st = ours.step(torch.from_numpy(h), torch.from_numpy(p), True)
    kbj, n0j, stj = ref.step(jnp.asarray(hj), jnp.asarray(pj),
                             jnp.asarray(True))
    assert kb.shape == (C, F, ours.fec.cfg.fec.kbch // 8)
    assert n0.shape == (C * F,)
    np.testing.assert_array_equal(kb.numpy(), np.asarray(kbj))
    np.testing.assert_array_equal(kb.numpy(), frames)
    assert int(st["bch_errors"]) == int(stj["bch_errors"]) == 0
    assert int(st["ldpc_iters"]) == int(stj["ldpc_iters"])
    assert int(st["ldpc_iters"]) > 1          # the decoder had work to do
    np.testing.assert_allclose(n0.numpy(), np.asarray(n0j), rtol=1e-5)
    np.testing.assert_allclose(float(st["metric_min"]),
                               float(stj["metric_min"]), rtol=1e-5)


def test_batched_pipeline_coarse_flag_and_numpy_inputs():
    """``coarse_corrected`` as a bool and as a tensor give the same step;
    numpy inputs go to the pipeline's device like tensors do."""
    kw = dict(modcod="qpsk1/2", frame_size="short", fec_batch=8)
    syms, frames = _symbols("qpsk1/2", False, 0.1, seed=9)
    pipe = BatchedPipeline(RxConfig(**kw), C, F, device="cpu")
    h, p = pipe.frame_inputs_from_symbols(syms)
    for cc in (False, torch.tensor(False)):
        kb, n0, st = pipe.step(h, p, cc)
        np.testing.assert_array_equal(kb.numpy(), frames)
        assert int(st["bch_errors"]) == 0
    # the first header's extension symbol (index -1) reads symbol 0
    hc, _ = pipe.channel_major_inputs(syms)
    np.testing.assert_array_equal(hc[:, 0, 0], hc[:, 0, 1])
    with pytest.raises(AssertionError, match="not enough symbols"):
        pipe.channel_major_inputs(syms[:, : F * pipe.frame_len + 90])
