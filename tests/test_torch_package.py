"""Package rules of the PyTorch/CUDA port.

- Importing every ``dvbs2rx_tpu_torch`` module and ``chip_smoke.py`` (in a
  fresh interpreter) leaves ``jax`` and every ``dvbs2rx_tpu`` module out of
  ``sys.modules``, and needs no nvcc; ``chip_smoke.py`` has no import of
  the JAX package anywhere in its source.
- Entry points default to the card: ``resolve_device(None)`` is CUDA, and
  raises ``RuntimeError`` without one.
- The port's ``RxConfig``/``RxStats`` have the JAX classes' field names and
  defaults, and ``__post_init__`` derives the same values.
- ``convert`` carries state dtype for dtype, and ``tables_from_spec``
  gives the tables the port's modules use.
"""

import ast
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dvbs2rx_tpu_torch
from dvbs2rx_tpu.rx import receiver as jreceiver
from dvbs2rx_tpu.rx.stream import StreamReceiver as JStreamReceiver

from dvbs2rx_tpu_torch import convert
from dvbs2rx_tpu_torch.rx import receiver
from dvbs2rx_tpu_torch.rx.acm_batch import BatchedACMReceiver
from dvbs2rx_tpu_torch.rx.stream import StreamReceiver
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamEngine
from dvbs2rx_tpu_torch.utils.runtime import resolve_device

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(dvbs2rx_tpu_torch.__path__,
                                              "dvbs2rx_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "dvbs2rx_tpu_torch.ops.ldpc_cuda" in mods
    assert "dvbs2rx_tpu_torch.rx.stream" in mods
    assert "dvbs2rx_tpu_torch.rx.vcm_stream" in mods
    assert "dvbs2rx_tpu_torch.tx.vcm" in mods
    assert "dvbs2rx_tpu_torch.rx.acm_batch" in mods
    assert "dvbs2rx_tpu_torch.ops.gardner_cuda" in mods
    assert "dvbs2rx_tpu_torch.ops.resample" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k.startswith('jaxlib') or "
        "k == 'dvbs2rx_tpu' or k.startswith('dvbs2rx_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("name", ["RxConfig", "RxStats"])
def test_config_fields_and_defaults_match_jax(name):
    ours = getattr(receiver, name)
    theirs = getattr(jreceiver, name)
    f0 = [(f.name, f.default) for f in dataclasses.fields(theirs)]
    f1 = [(f.name, f.default) for f in dataclasses.fields(ours)]
    assert f1 == f0


@pytest.mark.parametrize("kw", [{}, {"modcod": "8psk3/5", "pilots": True},
                                {"modcod": "qpsk1/2", "frame_size": "short"}])
def test_config_post_init_matches_jax(kw):
    a, b = jreceiver.RxConfig(**kw), receiver.RxConfig(**kw)
    for attr in ("modcod_num", "constellation", "rate", "pls"):
        assert getattr(a, attr) == getattr(b, attr), attr
    # the port's spec dataclasses are its own copies: compare field by field
    for attr in ("pls_info", "fec"):
        assert dataclasses.asdict(getattr(a, attr)) == \
            dataclasses.asdict(getattr(b, attr)), attr
    with pytest.raises(ValueError):
        receiver.RxConfig(modcod="qpsk9/9")
    with pytest.raises(ValueError):
        receiver.RxConfig(plsc_mode="nope")


def test_state_round_trip_keeps_dtypes():
    kw = dict(modcod="qpsk1/2", frame_size="short")
    jsr = JStreamReceiver(jreceiver.RxConfig(**kw), n_channels=2)
    sr = StreamReceiver(receiver.RxConfig(**kw), n_channels=2, device="cpu")
    jstate = jsr.init_state_np()
    ours = sr.init_state_np()
    assert {k: (v.shape, v.dtype) for k, v in ours.items()} == \
        {k: (v.shape, v.dtype) for k, v in jstate.items()}
    jstate["coarse_corrected"][1] = True
    st = convert.state_from_numpy(jstate, "cpu")
    assert st["coarse_corrected"].dtype == torch.bool
    assert st["sfill"].dtype == torch.int32
    back = convert.state_to_numpy(st)
    for k, v in jstate.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_tables_from_spec_match_the_modules():
    cfg = receiver.RxConfig(modcod="qpsk1/2", frame_size="short")
    t = convert.tables_from_spec(cfg, "cpu")
    stage = receiver.FECStage(cfg, "cpu")
    np.testing.assert_array_equal(t["pl_descramble"].numpy(),
                                  stage.descr.numpy())
    np.testing.assert_array_equal(t["bb_scramble"].numpy(),
                                  stage.bb_scramble.numpy())
    np.testing.assert_array_equal(t["bch_A"].numpy(), stage.bch._A.numpy())
    sr = StreamReceiver(cfg, n_channels=1, device="cpu")
    np.testing.assert_array_equal(t["rrc_bank"].numpy(), sr.sync.bank.numpy())
    assert int(t["ldpc_layer_ptr"][-1]) == t["ldpc_edge_base"].numel()


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        StreamReceiver(receiver.RxConfig(modcod="qpsk1/2",
                                         frame_size="short"),
                       n_channels=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        StreamReceiver(receiver.RxConfig(), n_channels=1, device=None)
    vcm = receiver.RxConfig(acm_vcm=True, pls_expected=(17, 49))
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        VCMStreamEngine(vcm)
    for make in (receiver.make_receiver, receiver.Receiver,
                 receiver.ACMReceiver,
                 lambda cfg: BatchedACMReceiver(cfg, 2)):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            make(vcm)


def test_resolve_device_defaults_to_the_card():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda:0")


def test_chip_smoke_imports_nothing_of_the_jax_package():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "dvbs2rx_tpu_torch.tx" in names      # the stimulus is the port's
    bad = [n for n in names if n == "dvbs2rx_tpu"
           or n.startswith("dvbs2rx_tpu.") or n.split(".")[0] == "jax"]
    assert not bad, bad
