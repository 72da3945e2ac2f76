#!/usr/bin/env python3
"""Where the rx app's time goes in ``chip_smoke.py`` phase 9's headline.

    python3 tools/torch_profile_app.py [--channels 64] [--top 20]
        [--device cuda] [--frame-size normal]

Makes phase 9 (b)'s files with the Tx app (``chip_smoke._app_stimulus``),
then decodes the 8 headline files, each repeated to ``--channels``
channels, with ``dvbs2_rx.main`` in this process: once to warm up, once
timed (the stats JSON's ``samples / elapsed_s``) with the time split by
host clock around the functions each part names (``_timed_split``): the
lockstep source (each ``next`` of ``iter_source_multi``) and inside it the
file reads (each ``next`` of ``iter_iq``), its ``np.concatenate`` and its
``np.stack``; the engine (``StreamEngine.receive``) and inside it its
``np.asarray``/``np.concatenate``, ``cplx.from_np`` (the
``ascontiguousarray`` copy of each block), ``StreamSession.prime`` and
``.step`` (the device step's enqueue and its host-to-device copy) and
``_update_stats`` (its reads wait for the card); the rest of each part,
and of the run (the TS writes). Then once under cProfile, whose table of
own times it prints: since Python 3.12 cProfile follows every thread on
one stack, so its cumulative and caller columns mix the engine's reader
thread with the main thread. It then decodes the same samples, already
in memory, through ``StreamEngine.receive`` in the blocks the app's
source yields (phase 5's way of feeding the engine). It prints all of that
and one JSON line. Needs one CUDA card (``--device cpu --frame-size
short`` with a few channels runs the same steps on the CPU, to rehearse
it).
"""

import argparse
import collections
import contextlib
import cProfile
import io
import json
import pstats
import shutil
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _decode(argv):
    """``dvbs2_rx.main(argv)``; returns its stats JSON."""
    from dvbs2rx_tpu_torch.apps import dvbs2_rx

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = dvbs2_rx.main(argv)
    if rc != 0:
        raise RuntimeError(f"rx app rc {rc}")
    return json.loads(err.getvalue().strip().splitlines()[-1])


def _timer(acc, key, fn):
    """fn with its host seconds added to ``acc[key]``."""
    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] += time.perf_counter() - t0
    return timed


def _timed_iter(acc, key, gen_fn):
    """The generator function gen_fn with the host seconds of each ``next``
    added to ``acc[key]``."""
    def timed(*a, **kw):
        it = gen_fn(*a, **kw)
        while True:
            t0 = time.perf_counter()
            blk = next(it, None)
            acc[key] += time.perf_counter() - t0
            if blk is None:
                return
            yield blk
    return timed


class _TimedModule:
    """A module whose functions named in ``keys`` add their host seconds to
    ``acc[keys[name]]``; every other attribute is the module's own."""

    def __init__(self, module, acc, keys):
        self._module = module
        for name, key in keys.items():
            setattr(self, name, _timer(acc, key, getattr(module, name)))

    def __getattr__(self, name):
        return getattr(self._module, name)


def _timed_split(argv):
    """``_decode(argv)`` with the host time of the lockstep source, the
    engine and the named functions inside each added up; each part's
    ``*_rest_s`` is its time outside the functions named in it."""
    from dvbs2rx_tpu_torch.apps import dvbs2_rx
    from dvbs2rx_tpu_torch.rx import stream

    acc = collections.defaultdict(float)
    eng, sess = stream.StreamEngine, stream.StreamSession
    patches = [
        (dvbs2_rx, "iter_source_multi",
         _timed_iter(acc, "source_s", dvbs2_rx.iter_source_multi)),
        (dvbs2_rx, "iter_iq",
         _timed_iter(acc, "source_file_reads_s", dvbs2_rx.iter_iq)),
        (dvbs2_rx, "np", _TimedModule(np, acc, {
            "concatenate": "source_concatenate_s",
            "stack": "source_stack_s"})),
        (eng, "receive", _timer(acc, "receive_s", eng.receive)),
        (stream, "np", _TimedModule(np, acc, {
            "asarray": "engine_asarray_s",
            "concatenate": "engine_concatenate_s"})),
        (stream, "cplx", _TimedModule(stream.cplx, acc, {
            "from_np": "engine_from_np_s"})),
        (sess, "prime", _timer(acc, "engine_prime_s", sess.prime)),
        (sess, "step", _timer(acc, "engine_step_s", sess.step)),
        (eng, "_update_stats", _timer(acc, "engine_update_stats_s",
                                      eng._update_stats)),
    ]
    with contextlib.ExitStack() as stack:
        for obj, name, new in patches:
            stack.enter_context(mock.patch.object(obj, name, new))
        stats = _decode(argv)
    split = dict(acc)
    split["source_rest_s"] = split["source_s"] - sum(
        v for k, v in split.items() if k.startswith("source_")
        and k not in ("source_s", "source_rest_s"))
    split["engine_rest_s"] = split["receive_s"] - sum(
        v for k, v in split.items() if k.startswith("engine_"))
    split["rest_s"] = (stats["elapsed_s"] - split["source_s"]
                       - split["receive_s"])
    return stats, split


def _top_own(stats, top):
    """The ``top`` functions by own seconds (cProfile's ``tottime``)."""
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"function": f"{Path(f[0]).name}:{f[1]}({f[2]})"
             if f[0] != "~" else f[2], "calls": nc, "own_s": tt}
            for f, (_cc, nc, tt, _ct, _callers) in rows]


def _engine_in_memory(args, files, names, C, device):
    """The headline's samples through ``StreamEngine.receive`` from memory,
    in blocks of the app's lockstep size: seconds and samples."""
    from dvbs2rx_tpu_torch.apps import dvbs2_rx
    from dvbs2rx_tpu_torch.rx.stream import StreamEngine

    rows = [np.fromfile(files[n][0], np.complex64) for n in names]
    n = min(r.size for r in rows)
    iq = np.stack([r[:n] for r in rows])
    r = dvbs2_rx.route(dvbs2_rx.argument_parser().parse_args(args))
    eng = StreamEngine(r.cfg, n_channels=C, device=device)
    try:
        blk = 1 << 20          # what iter_iq reads per file at a time
        t0 = time.perf_counter()
        for i in range(0, n, blk):
            eng.receive(iq[:, i: i + blk], flush=False)
        eng.receive(np.empty((C, 0), np.complex64), flush=True)  # syncs
        secs = time.perf_counter() - t0
    finally:
        eng.close()
    if eng.stats.bch_frame_errors:
        raise RuntimeError(f"engine in memory: {eng.stats}")
    return secs, iq.size


def main():
    import chip_smoke

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--channels", type=int, default=chip_smoke.APP_CHANNELS)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--frame-size", choices=["normal", "short"],
                   default="normal")
    a = p.parse_args()
    if a.device == "cuda":
        from dvbs2rx_tpu_torch import _build

        smi = chip_smoke.phase_device()
        _build.lib()
    else:
        smi = "cpu"
    d = ROOT / "build" / "profile_app"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    try:
        files = chip_smoke._app_stimulus(d, a.frame_size)
        C = a.channels
        names = [f"ccm{c % chip_smoke.APP_FILES}" for c in range(C)]
        opts = ["--modcod", "qpsk1/2", "--frame-size", a.frame_size,
                "--channels", str(C), "--device", a.device]
        argv = opts + [
            "--in-file", ",".join(str(files[n][0]) for n in names),
            "--out-file", ",".join(str(d / f"o{c}.ts") for c in range(C))]
        _decode(argv)                                   # warm-up
        timed, split = _timed_split(argv)
        prof = cProfile.Profile()
        prof.enable()
        profiled = _decode(argv)
        prof.disable()
        eng_secs, eng_samples = _engine_in_memory(argv, files, names, C,
                                                  a.device)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    top = _top_own(pstats.Stats(prof), a.top)
    rate = timed["samples"] / timed["elapsed_s"] / 1e6
    print(f"rx app --channels {C}: {timed['samples']} samples in "
          f"{timed['elapsed_s']} s = {rate:.3f} Msps (warm, unprofiled); "
          f"profiled {profiled['elapsed_s']} s; the same samples through "
          f"StreamEngine.receive from memory in {eng_secs:.3f} s = "
          f"{eng_samples / eng_secs / 1e6:.3f} Msps")
    print("  host clock, timed run: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(a.top)
    print(out.getvalue())
    print(json.dumps({"device": smi, "channels": C, "app_msps": rate,
                      "app_elapsed_s": timed["elapsed_s"],
                      "samples": timed["samples"],
                      "profiled_elapsed_s": profiled["elapsed_s"],
                      "engine_in_memory_s": eng_secs,
                      "engine_in_memory_msps": eng_samples / eng_secs / 1e6,
                      "split_s": split, "profile_top_own_s": top}))


if __name__ == "__main__":
    main()
