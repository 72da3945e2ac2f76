"""The port's last tools: ``tools/torch_iqrec.py`` and the examples.

- ``torch_iqrec list`` and ``replay`` on a small SigMF pair written by the
  port's ``dvbs2_rec`` from the port's Tx app (short QPSK 1/2 at 13 dB):
  the replay through the port's rx app (``--device cpu``) gives a TS that
  is a consecutive bit-exact run of the input packets (as
  ``tests/test_cli.py::test_cli_rec_and_replay`` for ``tools/iqrec.py``),
  and its command line is ``tools/iqrec.py``'s with the port's module.
- ``examples/torch_pl_sync_demo.py`` prints what
  ``examples/pl_sync_demo.py`` prints; ``examples/torch_loopback_sim.py``
  recovers its packets bit-exact at small size. Both on the CPU.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dvbs2rx_tpu_torch.apps import dvbs2_rec, dvbs2_tx

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "torch_iqrec", ROOT / "tools" / "torch_iqrec.py")
torch_iqrec = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_iqrec)


def _run(*argv, timeout=300):
    return subprocess.run([sys.executable, *map(str, argv)], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    rng = np.random.default_rng(13)
    pkts = rng.integers(0, 256, (60, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    pkts.tofile(d / "in.ts")
    assert dvbs2_tx.main(["--in-file", str(d / "in.ts"), "--out-file",
                          str(d / "iq.fc32"), "--modcod", "qpsk1/2",
                          "--frame-size", "short", "--snr", "13"]) == 0
    assert dvbs2_rec.main(["--in-file", str(d / "iq.fc32"), "--out",
                           str(d / "cap1"), "--modcod", "qpsk1/2",
                           "--frame-size", "short", "--samp-rate", "2e6",
                           "--sym-rate", "1e6", "--rolloff", "0.2"]) == 0
    return d, pkts


def test_list_prints_the_recording(recording, capsys):
    d, _ = recording
    assert torch_iqrec.main(["list", str(d)]) == 0
    line = capsys.readouterr().out.strip()
    n = os.path.getsize(d / "iq.fc32") // 8
    assert line.split()[:2] == ["cap1", str(n)]
    assert "modcod=qpsk1/2 frame=short pilots=False" in line
    assert torch_iqrec.main(["list", str(d / "none")]) == 0
    assert "no SigMF recordings" in capsys.readouterr().out


def test_replay_command_mirrors_the_jax_tool(recording):
    d, _ = recording
    cmd = torch_iqrec.replay_command(str(d / "cap1"), "o.ts",
                                     ["--device", "cpu"])
    assert cmd[1:3] == ["-m", "dvbs2rx_tpu_torch.apps.dvbs2_rx"]
    assert cmd[3:] == ["--in-file", str(d / "cap1.sigmf-data"),
                       "--out-file", "o.ts", "--modcod", "qpsk1/2",
                       "--frame-size", "short", "--rolloff", "0.2",
                       "--device", "cpu"]


def test_replay_gives_a_bit_exact_ts(recording):
    d, pkts = recording
    r = _run("tools/torch_iqrec.py", "replay", d / "cap1", "--out",
             d / "replay.ts", "--measure-cpu", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "dvbs2rx_tpu_torch.apps.dvbs2_rx" in r.stderr
    out = np.fromfile(d / "replay.ts", np.uint8).reshape(-1, 188)
    assert out.shape[0] >= 40
    starts = np.where((pkts == out[0]).all(axis=1))[0]
    assert starts.size == 1
    i = starts[0]
    n = min(len(pkts) - i, out.shape[0])
    np.testing.assert_array_equal(out[:n], pkts[i:i + n])


def test_pl_sync_demo_prints_what_the_jax_example_prints():
    ours = _run("examples/torch_pl_sync_demo.py", "--cpu")
    assert ours.returncode == 0, ours.stderr
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "examples/pl_sync_demo.py"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert ref.returncode == 0, ref.stderr
    assert ours.stdout == ref.stdout
    assert "peak spacing:    [8190, 8190] (expect 8190)" in ours.stdout


def test_loopback_example_recovers_its_packets():
    r = _run("examples/torch_loopback_sim.py", "--cpu", "--packets", "60",
             "--modcod", "qpsk1/2")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "bit-exact: True" in r.stdout
    assert "bch_frame_errors: 0" in r.stdout
