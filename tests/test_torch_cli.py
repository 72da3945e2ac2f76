"""The port's command-line apps (``dvbs2rx_tpu_torch.apps``) against the JAX
package's ``apps/dvbs2-rx``, ``apps/dvbs2-tx`` and ``apps/dvbs2-rec``.

- Routing: ``dvbs2_rx.route`` over a table of option lists, each with the
  engine, sps and resampler ratio ``apps/dvbs2-rx:294-410`` gives; the JAX
  app itself, loaded in-process with its engines replaced by recorders,
  gives the same engine, the same ``RxConfig`` field for field, the same
  resampler ratio and the same ``SystemExit`` messages. ``--ldpc-impl
  pallas`` is refused; without a card only ``--device cpu`` runs.
- Loopback, in-process through ``main(argv)`` on short frames on the CPU:
  every route's TS is a consecutive bit-exact run of the input packets
  (``tests/test_cli.py::_assert_consecutive``'s rule); the default route's
  bytes and the stats JSON's keys equal the JAX app's on the same file.
- Tx: the IQ equals the JAX app's, exactly at integer sps without a
  channel and for u8 output, within 1e-6 absolute (unit-power signal)
  through ``StreamingChannel`` and at sps 2.5.
- Rec: the SigMF data and meta equal the JAX app's, except
  ``core:datetime`` and ``core:recorder``.
"""

import dataclasses
import importlib.machinery
import importlib.util
import json
import logging
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig

from dvbs2rx_tpu_torch.apps import dvbs2_rec, dvbs2_rx, dvbs2_tx
from dvbs2rx_tpu_torch.tx import TxConfig, awgn_channel
from dvbs2rx_tpu_torch.tx.vcm import VCMTransmitter

from test_cli import _assert_consecutive

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = ["--modcod", "qpsk1/2", "--frame-size", "short"]
CPU = ["--device", "cpu"]


def _load_app(name):
    path = os.path.join(ROOT, "apps", name)
    loader = importlib.machinery.SourceFileLoader(
        "jax_app_" + name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_loader(loader.name, loader))
    loader.exec_module(mod)
    if hasattr(mod, "enable_compilation_cache"):
        mod.enable_compilation_cache = lambda: None   # tests/conftest.py's
    return mod


@pytest.fixture(scope="module")
def japps():
    return {n: _load_app(n) for n in ("dvbs2-rx", "dvbs2-tx", "dvbs2-rec")}


def _run_jax(app, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [app.__name__] + argv)
    return app.main()


def _packets(path, n, seed):
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (n, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    pkts.tofile(path)
    return pkts


def _stats(capsys):
    return json.loads(capsys.readouterr().err.strip().splitlines()[-1])


# ---------------------------------------------------------------- routing

S, V, R = dvbs2_rx.CCM_STREAM, dvbs2_rx.VCM_STREAM, dvbs2_rx.RECEIVER
EXIT = "exit"
# (options, expected (engine, sps, resampler ratio) or (EXIT, message start),
#  channels' in-files, out-files)
ROUTES = [
    ([], (S, 2, None)),
    (["--stream", "off"], (R, 2, None)),
    (["--stream", "on", "--pilots"], (S, 2, None)),
    (["--sps", "2.5"], (S, 2, 0.8)),
    (["--samp-rate", "2.5M", "--sym-rate", "1M"], (S, 2, 0.8)),
    (["--sps", "4"], (S, 2, 0.5)),
    (["--sps", "3", "--stream", "off"], (R, 2, 2 / 3)),
    (["--sps", "4", "--sym-sync-impl", "gardner"], (R, 4, None)),
    (["--sps", "6", "--sym-sync-impl", "gardner"], (R, 6, None)),
    (["--sps", "3", "--sym-sync-impl", "gardner"], (R, 2, 2 / 3)),
    (["--sym-sync-impl", "gardner"], (R, 2, None)),
    (["--pilots", "auto"], (V, 2, None)),
    (["--pilots", "auto", "--stream", "off"], (R, 2, None)),
    (["--pilots", "auto", "--sym-sync-impl", "gardner", "--sps", "4"],
     (R, 4, None)),
    (["--pl-acm-vcm"], (R, 2, None)),
    (["--pl-acm-vcm", "--pls-expected", "17", "49"], (V, 2, None)),
    (["--pl-acm-vcm", "--pls-expected", "0", "17"], (R, 2, None)),
    (["--pl-acm-vcm", "--plsc-mode", "differential", "--pls-expected",
      "19"], (V, 2, None)),
    (["--multistream", "on"], (V, 2, None)),
    (["--multistream", "auto", "--pilots"], (V, 2, None)),
    (["--out-stream", "bb"], (R, 2, None)),
    (["--ldpc-impl", "xla", "--ldpc-algo", "min-sum"], (S, 2, None)),
    (["--channels", "2"], (S, 2, None)),
    (["--channels", "3", "--pilots", "auto"], (V, 2, None)),
    (["--stream", "on", "--sym-sync-impl", "gardner"],
     (EXIT, "--stream on requires")),
    (["--stream", "on", "--pl-acm-vcm"], (EXIT, "--stream on requires")),
    (["--stream", "on", "--out-stream", "bb"], (EXIT, "--stream on requires")),
    (["--channels", "2", "--stream", "off"],
     (EXIT, "--channels > 1 requires a stream engine")),
    (["--channels", "2", "--pl-acm-vcm"],
     (EXIT, "--channels > 1 requires a stream engine")),
    (["--channels", "2", "--sps", "2.5"],
     (EXIT, "--channels > 1 requires an even-integer")),
    (["--channels", "2"], (EXIT, "--channels 2 needs 2 comma-separated "
                                 "--in-file"), 1, 2),
    (["--channels", "2"], (EXIT, "--channels 2 needs 2 comma-separated "
                                 "--out-file"), 2, 1),
    (["--sps", "1.0"], (EXIT, "samp-rate/sym-rate = 1 is below")),
    (["--samp-rate", "1M", "--sym-rate", "1M", "--sym-sync-impl", "gardner"],
     (EXIT, "samp-rate/sym-rate = 1 is below")),
]


def _channels(opts):
    return int(opts[opts.index("--channels") + 1]) if "--channels" in opts \
        else 1


def _route_argv(tmp_path, opts, n_in=None, n_out=None):
    """``opts`` plus existing empty in-files and out-file paths."""
    C = _channels(opts)
    ins = []
    for i in range(n_in or C):
        p = tmp_path / f"in{i}.fc32"
        p.write_bytes(b"")
        ins.append(str(p))
    outs = [str(tmp_path / f"out{i}.ts") for i in range(n_out or C)]
    return opts + ["--in-file", ",".join(ins), "--out-file", ",".join(outs)]


class _Routed(Exception):
    pass


def _jax_route(japp, argv, monkeypatch):
    """What the JAX app builds for ``argv``: its engines and resampler are
    replaced by recorders, and the first ``receive`` ends the run."""
    import dvbs2rx_tpu.ops.resample as jres
    import dvbs2rx_tpu.rx.receiver as jrec
    import dvbs2rx_tpu.rx.stream as jstream
    import dvbs2rx_tpu.rx.vcm_stream as jvcm

    seen = {"resample": None}

    class Resampler:
        def __init__(self, ratio):
            seen["resample"] = ratio

        def flush(self):
            return np.empty(0, np.complex64)

    class Engine:
        def receive(self, *a, **kw):
            raise _Routed

    def engine(kind):
        def make(cfg, n_channels=1):
            seen.update(engine=kind, cfg=cfg, channels=n_channels)
            return Engine()
        return make

    monkeypatch.setattr(jres, "DeviceResampler", Resampler)
    monkeypatch.setattr(jstream, "StreamEngine", engine(S))
    monkeypatch.setattr(jvcm, "VCMStreamEngine", engine(V))
    monkeypatch.setattr(jrec, "make_receiver", engine(R))
    try:
        _run_jax(japp, argv, monkeypatch)
    except SystemExit as e:
        return (EXIT, str(e.code)), seen
    except _Routed:
        return (seen["engine"], seen["cfg"].sps, seen["resample"]), seen
    raise AssertionError("the JAX app neither routed nor exited")


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JRxConfig)}


@pytest.mark.parametrize("row", ROUTES, ids=lambda r: " ".join(r[0]) or "default")
def test_routing_matches_the_jax_app(japps, monkeypatch, tmp_path, row):
    opts, want = row[0], row[1]
    argv = SHORT + _route_argv(tmp_path, opts, *row[2:])
    args = dvbs2_rx.argument_parser().parse_args(argv)
    if want[0] == EXIT:
        with pytest.raises(SystemExit) as e:
            dvbs2_rx.route(args)
        got = (EXIT, str(e.value.code))
        assert got[1].startswith(want[1]), got
    else:
        r = dvbs2_rx.route(args)
        got = (r.engine, r.cfg.sps, r.resample)
        assert got == want
        assert r.ratio == (float(args.sps) if args.sps else 2.0 if not
                           args.samp_rate else args.samp_rate / args.sym_rate)
    jgot, seen = _jax_route(japps["dvbs2-rx"], argv, monkeypatch)
    assert got == jgot
    if want[0] != EXIT:
        assert _cfg_fields(r.cfg) == _cfg_fields(seen["cfg"])
        assert seen["channels"] == args.channels


def test_ldpc_impl_pallas_is_refused_and_the_parsers_agree(japps):
    args = dvbs2_rx.argument_parser().parse_args(["--ldpc-impl", "pallas"])
    with pytest.raises(SystemExit) as e:
        dvbs2_rx.route(args)
    assert "--ldpc-impl pallas" in str(e.value.code)
    for impl in ("auto", "xla"):
        args = dvbs2_rx.argument_parser().parse_args(["--ldpc-impl", impl])
        assert dvbs2_rx.route(args).cfg.ldpc_impl == impl
    # same options and defaults as the JAX apps, plus --device cuda
    ours = vars(dvbs2_rx.argument_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == vars(japps["dvbs2-rx"].argument_parser().parse_args([]))
    assert vars(dvbs2_tx.argument_parser().parse_args([])) == \
        vars(japps["dvbs2-tx"].argument_parser().parse_args([]))
    for s in ("1M", "187.5k", "2e6", "1.0", "3m"):
        assert dvbs2_rx.eng_float(s) == japps["dvbs2-rx"].eng_float(s)


def test_without_a_card_only_device_cpu_runs(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = SHORT + _route_argv(tmp_path, [])
    with pytest.raises(SystemExit) as e:
        dvbs2_rx.main(argv)
    assert "CUDA is unavailable" in str(e.value.code)
    assert "--device cpu" in str(e.value.code)
    assert dvbs2_rx.main(argv + CPU) == 0      # an empty input decodes nothing


# ---------------------------------------------------------------- loopback

@pytest.fixture(scope="module")
def short_iq(tmp_path_factory):
    """80 packets of short QPSK 1/2 at 12 dB from the port's Tx app."""
    d = tmp_path_factory.mktemp("iq")
    pkts = _packets(d / "in.ts", 80, seed=7)
    assert dvbs2_tx.main(["--in-file", str(d / "in.ts"), "--out-file",
                          str(d / "iq.fc32"), *SHORT, "--snr", "12"]) == 0
    return d, pkts


def test_default_route_equals_the_jax_app(japps, monkeypatch, capsys,
                                          short_iq):
    d, pkts = short_iq
    argv = ["--in-file", str(d / "iq.fc32"), *SHORT]
    assert dvbs2_rx.main(argv + ["--out-file", str(d / "a.ts")] + CPU) == 0
    ours = _stats(capsys)
    assert _run_jax(japps["dvbs2-rx"], argv + ["--out-file", str(d / "j.ts")],
                    monkeypatch) == 0
    ref = _stats(capsys)
    out = np.fromfile(d / "a.ts", np.uint8)
    np.testing.assert_array_equal(out, np.fromfile(d / "j.ts", np.uint8))
    _assert_consecutive(out, pkts, 55)
    assert list(ours) == list(ref)             # the same keys, in order
    assert ours["locked"] and ours["bch_frame_errors"] == 0
    for k in ("bch_frames", "ldpc_total_iters", "sof_cnt", "lock_cnt"):
        assert ours[k] == ref[k], k
    assert ours["samples"] == ref["samples"] == os.path.getsize(
        d / "iq.fc32") // 8


def test_host_receiver_route_with_logs(capsys, short_iq):
    d, pkts = short_iq
    assert dvbs2_rx.main(["--in-file", str(d / "iq.fc32"), "--out-file",
                          str(d / "b.ts"), *SHORT, "--stream", "off",
                          "--log", "--log-period", "0"] + CPU) == 0
    err = capsys.readouterr().err.strip().splitlines()
    assert any(line.startswith("Lock=") for line in err)
    stats = json.loads(err[-1])
    assert stats["locked"] and stats["bch_frame_errors"] == 0
    _assert_consecutive(np.fromfile(d / "b.ts", np.uint8), pkts, 60)


def test_debug_log_names_no_kernel_launch_on_the_cpu(caplog, capsys,
                                                    short_iq):
    d, pkts = short_iq
    caplog.set_level(logging.INFO, logger="dvbs2-rx")
    assert dvbs2_rx.main(["--in-file", str(d / "iq.fc32"), "--out-file",
                          str(d / "log.ts"), *SHORT, "-d", "1"] + CPU) == 0
    msgs = [r.getMessage() for r in caplog.records if r.name == "dvbs2-rx"]
    route = dvbs2_rx.route(dvbs2_rx.argument_parser().parse_args(SHORT))
    assert f"route {route.describe()} channels=1 device=cpu" in msgs
    launches = [m for m in msgs if m.startswith("kernel launches ")]
    shapes = [m for m in msgs if m.startswith("kernel shapes ")]
    assert json.loads(launches[-1].split(" ", 2)[2]) == {
        "mf_segmented": 0, "gardner": 0, "ldpc_layered": 0,
        "bch_locator": 0, "bch_chien": 0, "crc8_validity": 0,
        "vcm_walk": 0, "plsync_header": 0, "plsync_stats": 0,
        "plsync_demap": 0, "frontend_rotate": 0, "frontend_agc": 0,
        "ffsync_track": 0, "rxspan": 0, "snr_refine": 0}
    assert json.loads(shapes[-1].split(" ", 2)[2]) == {
        "mf_segmented": [], "ldpc_layered": [], "plsync": [],
        "frontend": [], "ffsync_track": []}
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert stats["bch_frame_errors"] == 0
    _assert_consecutive(np.fromfile(d / "log.ts", np.uint8), pkts, 60)


def test_u8_input_route(tmp_path, capsys):
    pkts = _packets(tmp_path / "in.ts", 80, seed=8)
    assert dvbs2_tx.main(["--in-file", str(tmp_path / "in.ts"), "--out-file",
                          str(tmp_path / "iq.u8"), *SHORT, "--snr", "14",
                          "--out-iq-format", "u8"]) == 0
    assert dvbs2_rx.main(["--in-file", str(tmp_path / "iq.u8"),
                          "--out-file", str(tmp_path / "o.ts"), *SHORT,
                          "--in-iq-format", "u8"] + CPU) == 0
    assert _stats(capsys)["bch_frame_errors"] == 0
    _assert_consecutive(np.fromfile(tmp_path / "o.ts", np.uint8), pkts, 55)


def test_pilots_auto_goes_through_the_vcm_stream_engine(tmp_path, capsys):
    pkts = _packets(tmp_path / "in.ts", 120, seed=9)
    assert dvbs2_tx.main(["--in-file", str(tmp_path / "in.ts"), "--out-file",
                          str(tmp_path / "iq.fc32"), *SHORT, "--pilots",
                          "--snr", "12"]) == 0
    argv = ["--in-file", str(tmp_path / "iq.fc32"), "--out-file",
            str(tmp_path / "o.ts"), *SHORT, "--pilots", "auto"] + CPU
    assert dvbs2_rx.route(dvbs2_rx.argument_parser().parse_args(
        argv)).engine == V
    assert dvbs2_rx.main(argv) == 0
    stats = _stats(capsys)
    assert stats["bch_frame_errors"] == 0 and stats["bch_frames"] > 0
    _assert_consecutive(np.fromfile(tmp_path / "o.ts", np.uint8), pkts, 60)


def test_blind_acm_vcm_route(tmp_path, capsys):
    """``--pl-acm-vcm`` on piloted short QPSK 1/2 and 8PSK 3/5 frames with
    dummy frames (the port's ``tx.vcm``): the blind ``ACMReceiver``."""
    pkts = _packets(tmp_path / "in.ts", 150, seed=10)
    vtx = VCMTransmitter([
        TxConfig(modcod="qpsk1/2", frame_size="short", pilots=True),
        TxConfig(modcod="8psk3/5", frame_size="short", pilots=True)])
    iq = vtx.ts_to_iq(pkts.reshape(-1), schedule=[0, 1, -1])
    awgn_channel(iq, 13.0, sps=2, seed=11).astype(np.complex64).tofile(
        tmp_path / "iq.fc32")
    argv = ["--in-file", str(tmp_path / "iq.fc32"), "--out-file",
            str(tmp_path / "o.ts"), "--frame-size", "short",
            "--pl-acm-vcm"] + CPU
    assert dvbs2_rx.route(dvbs2_rx.argument_parser().parse_args(
        argv)).engine == R
    assert dvbs2_rx.main(argv) == 0
    stats = _stats(capsys)
    assert stats["bch_frame_errors"] == 0 and stats["dummy_cnt"] >= 3
    _assert_consecutive(np.fromfile(tmp_path / "o.ts", np.uint8), pkts, 80)


def test_fractional_sps_goes_through_the_resampler(tmp_path, capsys):
    pkts = _packets(tmp_path / "in.ts", 80, seed=13)
    assert dvbs2_tx.main(["--in-file", str(tmp_path / "in.ts"), "--out-file",
                          str(tmp_path / "iq.fc32"), *SHORT, "--snr", "15",
                          "--samp-rate", "2.5M", "--sym-rate", "1M"]) == 0
    assert dvbs2_rx.main(["--in-file", str(tmp_path / "iq.fc32"),
                          "--out-file", str(tmp_path / "o.ts"), *SHORT,
                          "--samp-rate", "2.5M", "--sym-rate", "1M"]
                         + CPU) == 0
    assert _stats(capsys)["bch_frame_errors"] == 0
    _assert_consecutive(np.fromfile(tmp_path / "o.ts", np.uint8), pkts, 50)


def test_two_channels_in_lockstep(tmp_path, capsys):
    ins, outs, pkts = [], [], []
    for c in range(2):
        pkts.append(_packets(tmp_path / f"in{c}.ts", 80, seed=20 + c))
        ins.append(str(tmp_path / f"iq{c}.fc32"))
        outs.append(str(tmp_path / f"out{c}.ts"))
        assert dvbs2_tx.main(["--in-file", str(tmp_path / f"in{c}.ts"),
                              "--out-file", ins[c], *SHORT, "--snr", "12",
                              "--seed", str(30 + c)]) == 0
    # the second file is shorter: the lockstep source stops with it
    with open(ins[1], "r+b") as f:
        f.truncate(os.path.getsize(ins[1]) - 8 * 4001 - 3)
    assert dvbs2_rx.main(["--in-file", ",".join(ins), "--out-file",
                          ",".join(outs), *SHORT, "--stream", "on",
                          "--channels", "2"] + CPU) == 0
    stats = _stats(capsys)
    assert stats["locked"] and stats["bch_frame_errors"] == 0
    assert stats["samples"] == 2 * (os.path.getsize(ins[1]) // 8)
    for c in range(2):
        _assert_consecutive(np.fromfile(outs[c], np.uint8), pkts[c], 45)


def test_lockstep_source_blocks_and_spectral_inversion(tmp_path):
    x = (np.arange(200_000) * (1 + 2j)).astype(np.complex64)
    for i, n in enumerate((200_000, 150_000)):
        x[:n].tofile(tmp_path / f"{i}.fc32")
    args = dvbs2_rx.argument_parser().parse_args(
        ["--in-file", f"{tmp_path / '0.fc32'},{tmp_path / '1.fc32'}",
         "--spectral-inversion"])
    # each file arrives in one read; the rows advance together and the
    # source stops at the first file that ends
    blocks = list(dvbs2_rx.iter_source_multi(args))
    assert [b.shape for b in blocks] == [(2, 150_000)]
    np.testing.assert_array_equal(blocks[0],
                                  np.stack([np.conj(x[:150_000])] * 2))


def test_pipe_through_the_module_entry_points(tmp_path):
    """cat in.ts | python -m ...dvbs2_tx | python -m ...dvbs2_rx > out.ts"""
    pkts = _packets(tmp_path / "in.ts", 80, seed=11)
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(tmp_path / "in.ts", "rb") as f:
        tx = subprocess.Popen(
            [sys.executable, "-m", "dvbs2rx_tpu_torch.apps.dvbs2_tx", *SHORT,
             "--snr", "12"], stdin=f, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, cwd=tmp_path, env=env)
        rx = subprocess.run(
            [sys.executable, "-m", "dvbs2rx_tpu_torch.apps.dvbs2_rx", *SHORT,
             "--stream", "off"] + CPU, stdin=tx.stdout,
            capture_output=True, cwd=tmp_path, env=env, timeout=300)
        tx.stdout.close()
        assert tx.wait(timeout=60) == 0 and rx.returncode == 0, rx.stderr
    out = np.frombuffer(rx.stdout, np.uint8)
    n = out.size // 188
    assert n >= 60
    np.testing.assert_array_equal(out[: n * 188].reshape(n, 188), pkts[:n])


def test_mon_server_serves_the_stats():
    class Rx:
        def get_stats(self, sym_rate):
            return {"lock": True, "sym_rate_seen": sym_rate}

    server = dvbs2_rx.start_mon_server(Rx(), 0, {"freq": 1e9}, 2e6)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    assert body == {"lock": True, "sym_rate_seen": 2e6, "freq": 1e9}


# ---------------------------------------------------------------- tx, rec

TX_CASES = [  # (options, absolute tolerance or None for byte equality)
    ([], None),
    (["--pilots", "--out-iq-format", "u8"], None),
    (["--sps", "4", "--rolloff", "0.35"], None),
    (["--snr", "12", "--freq-offset", "1e-4", "--phase", "0.3", "--seed",
      "3"], 1e-6),
    (["--sps", "2.5", "--snr", "15"], 1e-6),
]


@pytest.mark.parametrize("opts,tol", TX_CASES,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else str(v))
def test_tx_equals_the_jax_app(japps, monkeypatch, capsys, tmp_path, opts,
                               tol):
    # two 1,024-packet reads; fewer at sps 2.5 (the arbitrary resampler)
    _packets(tmp_path / "in.ts", 300 if "2.5" in opts else 1100, seed=5)
    base = ["--in-file", str(tmp_path / "in.ts"), *SHORT, *opts]
    assert dvbs2_tx.main(base + ["--out-file", str(tmp_path / "a")]) == 0
    ours = capsys.readouterr().err
    assert _run_jax(japps["dvbs2-tx"], base + ["--out-file",
                                               str(tmp_path / "b")],
                    monkeypatch) == 0
    assert ours == capsys.readouterr().err
    a, b = (tmp_path / "a").read_bytes(), (tmp_path / "b").read_bytes()
    if tol is None:
        assert a == b
    else:
        x, y = (np.frombuffer(v, np.complex64) for v in (a, b))
        assert x.size == y.size
        np.testing.assert_allclose(x, y, rtol=0, atol=tol)


def test_tx_without_a_complete_packet_returns_1(tmp_path, capsys):
    (tmp_path / "in.ts").write_bytes(bytes([0x47] + [0] * 100))
    assert dvbs2_tx.main(["--in-file", str(tmp_path / "in.ts"), "--out-file",
                          str(tmp_path / "iq"), *SHORT]) == 1
    assert "no complete TS packets" in capsys.readouterr().err


def test_tx_reads_whole_packets_across_short_reads():
    data = np.random.default_rng(1).integers(0, 256, 188 * 40, np.uint8)
    data = data.tobytes()
    pieces = iter([1, 187, 189, 500, 93, 7, 4000, 10000])
    pos = [0]

    def reader(n):
        k = min(n, next(pieces, n))
        b = data[pos[0]: pos[0] + k]
        pos[0] += len(b)
        return b

    chunks = list(dvbs2_tx._read_packets(reader, chunk_pkts=8))
    assert all(c.size % 188 == 0 for c in chunks)
    assert np.concatenate(chunks).tobytes() == data


def test_rec_equals_the_jax_app(japps, monkeypatch, capsys, tmp_path):
    x = np.random.default_rng(2).normal(size=(999, 2)).astype(np.float32)
    x.view(np.complex64).tofile(tmp_path / "iq.fc32")
    opts = ["--in-file", str(tmp_path / "iq.fc32"), "--modcod", "qpsk1/2",
            "--frame-size", "short", "--samp-rate", "2e6", "--sym-rate",
            "1e6", "--rolloff", "0.2", "--pilots", "--author", "a",
            "--description", "d", "--hardware", "h", "--freq", "1.2e9"]
    assert dvbs2_rec.main(opts + ["--out", str(tmp_path / "a")]) == 0
    assert _run_jax(japps["dvbs2-rec"], opts + ["--out", str(tmp_path / "b")],
                    monkeypatch) == 0
    assert (tmp_path / "a.sigmf-data").read_bytes() == \
        (tmp_path / "b.sigmf-data").read_bytes()
    metas = [json.loads((tmp_path / f"{n}.sigmf-meta").read_text())
             for n in "ab"]
    for m in metas:
        del m["captures"][0]["core:datetime"]
    assert metas[0]["global"].pop("core:recorder") == dvbs2_rec.RECORDER
    metas[1]["global"].pop("core:recorder")
    assert metas[0] == metas[1]
    # u8 input converts like the JAX reader
    u8 = np.random.default_rng(3).integers(0, 256, 600, np.uint8)
    u8.tofile(tmp_path / "iq.u8")
    for app, out in ((dvbs2_rec.main, "c"), (None, "d")):
        argv = ["--in-file", str(tmp_path / "iq.u8"), "--iq-format", "u8",
                "--out", str(tmp_path / out)]
        rc = app(argv) if app else _run_jax(japps["dvbs2-rec"], argv,
                                            monkeypatch)
        assert rc == 0
    assert (tmp_path / "c.sigmf-data").read_bytes() == \
        (tmp_path / "d.sigmf-data").read_bytes()


def test_apps_import_without_side_effects():
    """Importing the apps parses nothing, starts no thread and opens no
    file: their work is in ``main``."""
    code = ("import sys, threading\n"
            "sys.argv = ['x', '--no-such-option']\n"
            "import dvbs2rx_tpu_torch.apps.dvbs2_rx, "
            "dvbs2rx_tpu_torch.apps.dvbs2_tx, dvbs2rx_tpu_torch.apps.dvbs2_rec\n"
            "assert threading.active_count() == 1\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
