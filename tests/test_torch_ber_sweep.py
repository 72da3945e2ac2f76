"""``tools/torch_ber_sweep.py`` against ``tools/ber_sweep.py`` on the CPU.

Both tools draw from ``np.random.default_rng(0)`` in the same order, so on
the same arguments their counts are comparable one for one. The JAX tool
runs as users run it (``--cpu --json``, a subprocess with
``JAX_PLATFORMS=cpu``); the port's through its ``main`` on the same
arguments:

- QPSK 1/2 short frames at 1.4 dB Es/N0, 8 frames in one batch of 8, 25
  iterations: near the short code's waterfall, where the JAX tool gives
  FER 0.5 and BCH corrects some frames (post-BCH BER below post-LDPC), so
  the port's BCH decoder sees residual errors, frames beyond t included;
- the PLSC sweep at -6.61 dB, 300 PLHEADERs (a point of
  ``docs/plsc_fer.json``), printed as text by both.

Tolerance: none. Every figure is a count over the same totals, and the
counts are equal: the LLRs come from the same float32 products of the
same symbols and noise, rounded half to even in both, so no int8 tie can
move (``tests/test_torch_vcm.py``'s ``_assert_equal_but_ties`` is not
needed here); the decoders are integer and bit-exact to JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "torch_ber_sweep", ROOT / "tools" / "torch_ber_sweep.py")
torch_ber_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_ber_sweep)

FEC_ARGS = ["--modcod", "qpsk1/2", "--frame-size", "short", "--esn0", "1.4",
            "--frames", "8", "--batch", "8", "--iterations", "25"]
PLSC_ARGS = ["--plsc", "--esn0", "-6.61", "--frames", "300"]


def _jax_tool(*argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "tools/ber_sweep.py", "--cpu", *argv],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


def test_fec_sweep_counts_equal_the_jax_tool(capsys):
    want = json.loads(_jax_tool("--json", *FEC_ARGS)[-1])
    assert torch_ber_sweep.main(["--cpu", "--json", *FEC_ARGS]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    point = got["points"][0]
    # near the waterfall: some frames fail, BCH corrects residual errors
    assert 0 < point["fer"] < 1
    assert point["post_bch_ber"] < point["post_ldpc_ber"]


def test_plsc_sweep_prints_what_the_jax_tool_prints(capsys):
    want = _jax_tool(*PLSC_ARGS)
    assert torch_ber_sweep.main(["--cpu", *PLSC_ARGS]) == 0
    assert capsys.readouterr().out.strip().splitlines() == want
    r = torch_ber_sweep.plsc_sweep([-6.61], 300, device="cpu")
    assert r["points"][0]["fer_soft"] < r["points"][0]["fer_hard"] < \
        r["points"][0]["fer_diff"]


def test_without_a_card_the_sweep_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep runs on it")
    with pytest.raises(RuntimeError):
        torch_ber_sweep.fec_sweep("qpsk1/2", "short", [1.4], 1, 1)
    with pytest.raises(RuntimeError):
        torch_ber_sweep.plsc_sweep([-6.61], 1)
