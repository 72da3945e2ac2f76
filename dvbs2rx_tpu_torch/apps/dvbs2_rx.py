"""dvbs2-rx: DVB-S2 receiver CLI of the PyTorch/CUDA port (IQ in -> MPEG TS
out).

    python -m dvbs2rx_tpu_torch.apps.dvbs2_rx --in-file iq.fc32 \\
        --out-file out.ts --modcod qpsk1/2 --frame-size short

Counterpart of ``apps/dvbs2-rx``, with its options, defaults and messages:
full receive chain with frame/freq/phase sync, LDPC+BCH decoding and TS
recovery, periodic stats logging and an optional HTTP JSON monitoring
server. ``route`` decides, from the options alone, which receiver runs
(``apps/dvbs2-rx:294-410``):

- the oversampling ratio: an even integer sps goes straight to the Gardner
  front end, sps 2 to the feed-forward one; any other ratio goes through
  ``DeviceResampler(2 / ratio)`` to sps 2; below 1.05 the app exits;
- the PLS set: ``--pl-acm-vcm`` (blind), ``--pilots auto`` (both pilot
  settings of the MODCOD) and ``--multistream on|auto`` (one PLS, dummy
  frames expected) run the ACM/VCM receivers;
- the receiver: CCM with ``ffw`` timing and TS output streams through
  ``StreamEngine``; ACM/VCM with a known PLS set and no dummy PLS through
  ``VCMStreamEngine``; everything else through ``make_receiver``.

The port's one addition is ``--device``: the receiver runs on the card
unless ``--device cpu`` asks for the CPU; without a card the app exits.
``--ldpc-impl pallas`` (the JAX package's Pallas decoder) is refused: the
port decodes with its CUDA kernel on the card and its plain version on the
CPU, whatever ``--ldpc-impl`` says.
"""

import argparse
import json
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from .. import __version__
from .._build import launch_counts
from ..io.iq import iter_iq
from ..ops import (ffsync_cuda, fir_cuda, frontend_cuda, ldpc_cuda,
                   plsync_cuda)
from ..ops.resample import DeviceResampler
from ..rx.receiver import RxConfig, make_receiver
from ..rx.stream import StreamEngine
from ..rx.vcm_stream import VCMStreamEngine
from ..spec.pls import parse_pls
from ..utils.params import dvbs2_pls
from ..utils.runtime import resolve_device

log = logging.getLogger("dvbs2-rx")

# route() engines
CCM_STREAM, VCM_STREAM, RECEIVER = "ccm-stream", "vcm-stream", "receiver"


def eng_float(s):
    """Engineering-notation float: accepts '1M', '187.5k', '2e6', '1.0'."""
    s = s.strip()
    suffixes = {"k": 1e3, "M": 1e6, "G": 1e9, "m": 1e-3, "u": 1e-6}
    if s and s[-1] in suffixes:
        return float(s[:-1]) * suffixes[s[-1]]
    return float(s)


def _log_simple(d):
    """Reference one-line summary format (apps/dvbs2-rx:1122-1146)."""
    line = "Lock={}".format(d["lock"])
    if d["lock"]:
        line += "; "
        if d["snr"] is not None:
            line += "SNR={:.2f}; ".format(d["snr"])
        line += "FECFRAMEs={:d}; ".format(d["fec"]["frames"])
        if d["fec"]["fer"] is not None:
            line += "FER={:.1e}; ".format(d["fec"]["fer"])
        line += "TS Packets={:d}; ".format(d["mpeg-ts"]["packets"])
        if d["mpeg-ts"]["per"] is not None:
            line += "PER={:.1e}".format(d["mpeg-ts"]["per"])
    return line


def start_mon_server(rx, port, extra, sym_rate=None):
    """Serve ``rx.get_stats(sym_rate)`` plus ``extra`` as JSON over HTTP on
    ``port`` from a daemon thread; the caller shuts the server down."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            stats = rx.get_stats(sym_rate)
            stats.update(extra)
            body = json.dumps(stats).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = HTTPServer(("0.0.0.0", port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def argument_parser():
    p = argparse.ArgumentParser(
        prog="dvbs2-rx", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-d", "--debug", type=int, default=0,
                   help="debugging level (0=warnings, 1=info, 2+=debug)")
    p.add_argument("-v", "--version", action="version",
                   version=f"dvbs2rx_tpu_torch {__version__}")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the receiver runs: the card (default) or, "
                   "only when asked, the CPU")

    src = p.add_argument_group("Source Options")
    src.add_argument("--source", choices=["file", "fd"], default="file")
    src.add_argument("--in-file", default="-",
                     help="input IQ file ('-' = stdin)")
    src.add_argument("--in-fd", type=int, default=None,
                     help="input file descriptor (implies --source=fd)")
    src.add_argument("--in-iq-format", "--in-format", dest="in_iq_format",
                     choices=["fc32", "u8"], default="fc32")
    src.add_argument("--in-repeat", action="store_true",
                     help="read repeatedly from the input file")
    src.add_argument("--in-real-time", action="store_true",
                     help="throttle the input to simulate the sample rate")

    snk = p.add_argument_group("Sink Options")
    snk.add_argument("--sink", choices=["file", "fd"], default="file")
    snk.add_argument("--out-file", default="-",
                     help="output TS file ('-' = stdout)")
    snk.add_argument("--out-fd", type=int, default=None,
                     help="output file descriptor (implies --sink=fd)")
    snk.add_argument("--out-stream", choices=["ts", "bb"], default="ts",
                     help="output MPEG TS packets or raw descrambled BBFRAMEs")

    rates = p.add_argument_group("Rate Options")
    rates.add_argument("--freq", type=eng_float, default=1e9,
                       help="carrier or intermediate frequency in Hz "
                       "(metadata; reported with the stats)")
    rates.add_argument("--samp-rate", type=eng_float, default=None,
                       help="sampling rate in samples/second (with --sym-rate,"
                       " determines the oversampling ratio)")
    rates.add_argument("-s", "--sym-rate", type=eng_float, default=1e6,
                       help="symbol rate in bauds")
    rates.add_argument("--sps", type=float, default=None,
                       help="oversampling ratio directly (overrides rates; "
                       "non-even-integer ratios engage the rational "
                       "pre-resampler)")
    rates.add_argument("--spectral-inversion", action="store_true",
                       help="input is spectrally inverted (LO freq > RF freq)")

    dvb = p.add_argument_group("DVB-S2 Options")
    dvb.add_argument("-m", "--modcod", default="qpsk1/4")
    dvb.add_argument("-f", "--frame-size", choices=["normal", "short"],
                     default="normal")
    dvb.add_argument("--pilots", nargs="?", const="on", default="off",
                     choices=["on", "off", "auto"],
                     help="whether PLFRAMEs contain pilots; 'auto' accepts "
                     "both pilot configurations of the target MODCOD")
    dvb.add_argument("--multistream", choices=["on", "off", "auto"],
                     default="off",
                     help="expect multiple input streams (MIS) and dummy "
                     "PLFRAMEs")
    dvb.add_argument("--pl-acm-vcm", action="store_true",
                     help="process all PLFRAMEs regardless of PLS "
                     "(PLSC-driven variable-MODCOD demodulation)")
    dvb.add_argument("--plsc-mode",
                     choices=["coherent-soft", "coherent-hard",
                              "differential"],
                     default="coherent-soft",
                     help="PLSC decode mode (reference pl_signaling.cc "
                     "coherent/soft combinations; differential is "
                     "CFO-robust hard decoding)")
    dvb.add_argument("--pls-expected", type=int, nargs="*", default=None,
                     help="a-priori PLS values present in the stream: "
                     "restricts the PLSC ML search (reference "
                     "expected_plsc); distinct from the output filter")
    dvb.add_argument("-r", "--rolloff", type=float, default=0.2,
                     choices=[0.35, 0.25, 0.2, 0.15, 0.1, 0.05],
                     help="rolloff factor (0.15/0.1/0.05 are DVB-S2X)")
    dvb.add_argument("--rrc-delay", type=int, default=5,
                     help="RRC matched filter delay in symbol periods")
    dvb.add_argument("--gold-code", type=int, default=0)

    agc = p.add_argument_group("AGC Options")
    agc.add_argument("--agc-gain", type=eng_float, default=1.0,
                     help="initial AGC gain")
    agc.add_argument("--agc-rate", type=eng_float, default=1e-5,
                     help="AGC update rate")
    agc.add_argument("--agc-ref", type=eng_float, default=1.0,
                     help="AGC reference (target RMS) value")

    sync = p.add_argument_group("Synchronization Options")
    sync.add_argument("--sym-sync-impl", choices=["ffw", "gardner"],
                      default="ffw",
                      help="symbol synchronizer: feed-forward O&M (the "
                      "matched-filter kernel) or the reference-faithful "
                      "Gardner loop (the Gardner kernel)")
    sync.add_argument("--sym-sync-loop-bw", type=float, default=0.01)
    sync.add_argument("--sym-sync-damping", type=float, default=1.0)
    sync.add_argument("--sym-sync-rrc-nfilts", type=int, default=128,
                      help="number of polyphase RRC interpolator subfilters")
    sync.add_argument("--pl-freq-est-period", type=int, default=30)
    sync.add_argument("--frame-sync-unlock-thresh", type=int, default=3)
    sync.add_argument("--stream", choices=["auto", "on", "off"],
                      default="auto",
                      help="device-resident stream engine for the CCM/ffw "
                      "steady state (one IQ->BBFRAME step, all receiver "
                      "state on the device, automatic re-acquisition); "
                      "auto enables it whenever the configuration allows")
    sync.add_argument("--channels", type=int, default=1,
                      help="batched channels for the stream engine (each "
                      "input file/fd row is one channel; single-channel "
                      "otherwise)")

    fec = p.add_argument_group("FEC Options")
    fec.add_argument("--ldpc-iterations", type=int, default=25)
    fec.add_argument("--ldpc-impl", choices=["auto", "pallas", "xla"],
                     default="auto",
                     help="the JAX package's decoder choice; the port "
                     "refuses 'pallas' and decodes with its CUDA kernel "
                     "(its plain version on the CPU) otherwise")
    fec.add_argument("--ldpc-algo",
                     choices=["offset-min-sum", "min-sum", "min-sum-c"],
                     default="offset-min-sum",
                     help="check-node rule (reference algorithms.hh; "
                     "offset-min-sum is the production configuration)")
    fec.add_argument("--ldpc-update", choices=["normal", "self-corrected"],
                     default="normal",
                     help="message update rule (SelfCorrectedUpdate zeroes "
                     "messages on sign flips)")
    fec.add_argument("--fec-batch", type=int, default=8)

    mon = p.add_argument_group("Monitoring Options")
    mon.add_argument("--log", "--log-stats", dest="log_stats",
                     action="store_true",
                     help="log a one-line receiver summary periodically")
    mon.add_argument("--log-all", action="store_true",
                     help="log all receiver metrics periodically as JSON")
    mon.add_argument("--log-period", type=float, default=5.0)
    mon.add_argument("--mon-server", action="store_true",
                     help="serve stats as JSON over HTTP")
    mon.add_argument("--mon-port", type=int, default=9004)
    return p


@dataclass(frozen=True)
class Route:
    """What ``main`` runs for a set of options: ``engine`` (``CCM_STREAM``,
    ``VCM_STREAM`` or ``RECEIVER``), the receiver's configuration, the
    input oversampling ratio and the ``DeviceResampler`` ratio (None when
    the input goes to the front end as it is)."""
    engine: str
    cfg: RxConfig
    ratio: float
    resample: float = None

    def describe(self) -> str:
        """``key=value`` words without spaces inside a value."""
        pls = self.cfg.pls_expected or self.cfg.pls_list
        return (f"engine={self.engine} sps={self.cfg.sps} "
                f"resample={self.resample} acm_vcm={self.cfg.acm_vcm} "
                f"pls={','.join(map(str, pls)) or 'any'}")


def route(args) -> Route:
    """The receiver ``apps/dvbs2-rx`` builds for parsed options, decided
    from the options alone (no device, no file). Raises ``SystemExit``
    with the JAX app's message where it exits, and for ``--ldpc-impl
    pallas``."""
    if args.ldpc_impl == "pallas":
        raise SystemExit(
            "--ldpc-impl pallas selects the JAX package's Pallas decoder; "
            "this port decodes LDPC with its CUDA kernel on the card and "
            "its plain version on the CPU (use --ldpc-impl auto)")
    # Oversampling ratio: the front end natively consumes an even integer
    # sps (2 for the feed-forward path); any other ratio is converted by a
    # rational pre-resampler (the reference likewise accepts fractional sps
    # only through its in-tree symbol-sync path, apps/dvbs2-rx:887-916).
    if args.sps is not None:
        ratio = float(args.sps)
    elif args.samp_rate is not None:
        ratio = args.samp_rate / args.sym_rate
    else:
        ratio = 2.0
    if ratio < 1.05:
        raise SystemExit(f"samp-rate/sym-rate = {ratio:g} is below the "
                         "signal bandwidth (need > 1 sample/symbol)")
    resample = None
    is_even_int = float(ratio).is_integer() and int(ratio) % 2 == 0
    if is_even_int and (args.sym_sync_impl == "gardner" or ratio == 2):
        sps = int(ratio)
    else:
        sps = 2
        resample = 2.0 / ratio

    # PLS handling: CCM with fixed pilots has one frame geometry;
    # pilots=auto, MIS (dummy PLFRAMEs expected between data frames), or
    # ACM/VCM uses the PLSC-driven variable-MODCOD receiver
    # (reference --pl-acm-vcm + --multistream + pls_filter,
    # apps/dvbs2-rx:764-830 and plsync_cc_impl.cc:102-141).
    multistream = args.multistream in ("on", "auto")
    acm_vcm = args.pl_acm_vcm or args.pilots == "auto" or multistream
    short = args.frame_size == "short"
    if args.pl_acm_vcm:
        pls_list = ()  # all non-dummy PLS values
    elif args.pilots == "auto":
        pls_list = tuple(dvbs2_pls(args.modcod, short, pilots)
                         for pilots in (False, True))
    elif multistream:
        # CCM/MIS: one target PLS, but dummy PLFRAMEs must be recognized
        # and skipped, so run the PLSC-driven receiver with a 1-PLS filter
        pls_list = (dvbs2_pls(args.modcod, short, args.pilots == "on"),)
    else:
        pls_list = ()

    cfg = RxConfig(
        modcod=args.modcod,
        frame_size=args.frame_size,
        pilots=args.pilots == "on",
        rolloff=args.rolloff,
        sps=sps,
        gold_code=args.gold_code,
        sym_sync_impl=args.sym_sync_impl,
        sym_sync_loop_bw=args.sym_sync_loop_bw,
        damping=args.sym_sync_damping,
        rrc_delay=args.rrc_delay,
        n_subfilt=args.sym_sync_rrc_nfilts,
        coarse_period=args.pl_freq_est_period,
        unlock_thresh=args.frame_sync_unlock_thresh,
        ldpc_max_trials=args.ldpc_iterations,
        ldpc_impl=args.ldpc_impl,
        ldpc_algo=args.ldpc_algo,
        ldpc_update=args.ldpc_update,
        fec_batch=args.fec_batch,
        agc_gain=args.agc_gain,
        agc_rate=args.agc_rate,
        agc_ref=args.agc_ref,
        out_stream=args.out_stream,
        acm_vcm=acm_vcm,
        pls_list=pls_list,
        pls_expected=tuple(args.pls_expected) if args.pls_expected else (),
        plsc_mode=args.plsc_mode,
    )
    # stream-engine eligibility: CCM -> StreamEngine; ACM/VCM with a known
    # a-priori PLS set (mixed frame sizes allowed) -> VCMStreamEngine (the
    # device-resident variable-MODCOD walk); anything else (fully blind
    # --pl-acm-vcm, bb output, Gardner timing) -> host receivers
    base_ok = cfg.sym_sync_impl == "ffw" and args.out_stream == "ts"
    ccm_streamable = base_ok and not acm_vcm
    vcm_pls = tuple(cfg.pls_expected or cfg.pls_list)
    vcm_streamable = (
        base_ok and acm_vcm and bool(vcm_pls)
        and not any(parse_pls(p).dummy_frame for p in vcm_pls)
    )
    use_stream = args.stream != "off" and (ccm_streamable or vcm_streamable)
    if args.stream == "on" and not use_stream:
        raise SystemExit(
            "--stream on requires --sym-sync-impl ffw, --out-stream ts, "
            "and either CCM or ACM/VCM with an a-priori PLS set "
            "(--pls-expected / pilots auto / MIS)"
        )
    C = args.channels
    if not use_stream:
        if C > 1:
            raise SystemExit("--channels > 1 requires a stream engine "
                             "(--sym-sync-impl ffw + --out-stream ts)")
        return Route(RECEIVER, cfg, ratio, resample)
    if C > 1:
        if resample is not None:
            raise SystemExit("--channels > 1 requires an even-integer "
                             "oversampling ratio (no pre-resampler)")
        # the JAX app checks the out-files before it reads the in-files
        if len(args.out_file.split(",")) != C:
            raise SystemExit(f"--channels {C} needs {C} comma-separated "
                             "--out-file paths")
        if len(args.in_file.split(",")) != C:
            raise SystemExit(f"--channels {C} needs {C} "
                             "comma-separated --in-file paths")
    return Route(CCM_STREAM if ccm_streamable else VCM_STREAM, cfg, ratio,
                 resample)


def build(r: Route, n_channels: int, device):
    """The receiver and the resampler (or None) of a route on ``device``."""
    resampler = (DeviceResampler(r.resample, device=device)
                 if r.resample is not None else None)
    if r.engine == CCM_STREAM:
        rx = StreamEngine(r.cfg, n_channels=n_channels, device=device)
    elif r.engine == VCM_STREAM:
        rx = VCMStreamEngine(r.cfg, n_channels=n_channels, device=device)
    else:
        rx = make_receiver(r.cfg, device=device)
    return rx, resampler


def iter_source(args, in_ratio):
    """Yield complex64 IQ chunks per the source/format/repeat/throttle flags.

    ``in_ratio`` is the INPUT oversampling ratio (samples per symbol at the
    source, before any rational pre-resampler) so --in-real-time throttles at
    the true input sample rate."""
    samp_rate = args.samp_rate if args.samp_rate else args.sym_rate * in_ratio
    if args.in_fd is not None:
        src = args.in_fd
    elif args.in_file == "-":
        src = "-"
    else:
        src = args.in_file
    repeat = args.in_repeat and isinstance(src, str) and src != "-"
    t0 = time.time()
    sent = 0
    while True:
        for chunk in iter_iq(src, args.in_iq_format):
            if args.spectral_inversion:
                chunk = np.conj(chunk)
            if args.in_real_time:
                sent += chunk.size
                ahead = sent / samp_rate - (time.time() - t0)
                if ahead > 0:
                    time.sleep(ahead)
            yield chunk
        if not repeat:
            return


def iter_source_multi(args):
    """Lockstep multi-file source for the batched stream engine: reads N
    comma-separated input files and yields (C, n) sample blocks whose rows
    advance together (each file is one channel), at least 2^17 samples per
    row while every file lasts; it stops at the first file that ends."""
    files = args.in_file.split(",")
    iters = [iter_iq(f, args.in_iq_format) for f in files]
    bufs = [np.empty(0, np.complex64) for _ in files]
    target = 1 << 17
    while True:
        done = False
        for i, it in enumerate(iters):
            while bufs[i].size < target and not done:
                try:
                    nxt = next(it)
                except StopIteration:
                    done = True
                    break
                if args.spectral_inversion:
                    nxt = np.conj(nxt)
                bufs[i] = np.concatenate([bufs[i], nxt])
        n = min(b.size for b in bufs)
        if n == 0:
            return
        yield np.stack([b[:n] for b in bufs])
        bufs = [b[n:] for b in bufs]
        if done:
            return


def kernel_launches() -> dict:
    """The port's kernel launch counters: how many times this process
    launched each hand-written kernel (none run on the CPU)."""
    return launch_counts()


def kernel_shapes() -> dict:
    """The shapes this process launched the MF, LDPC, PL sync and front-end
    kernels at, each with its launches: ``[C, n, S, seg_len, L, sps,
    off_bound, (block length with in-place starts,) launches]``, ``[code
    table, B, max_trials, launches]``, the PL sync kernels' layouts
    (``ops.plsync_cuda.LAUNCH_SHAPES``' keys), the front end's ``[C, n_in,
    N or null, AGC mode, launches]`` and the O&M tracker's ``[C, N, block
    length or null, n_out, launches]``."""
    return {"mf_segmented": [[*k, v] for k, v in
                             fir_cuda.LAUNCH_SHAPES.items()],
            "ldpc_layered": [[*k, v] for k, v in
                             ldpc_cuda.LAUNCH_SHAPES.items()],
            "plsync": [[*k, v] for k, v in
                       plsync_cuda.LAUNCH_SHAPES.items()],
            "frontend": [[*k, v] for k, v in
                         frontend_cuda.LAUNCH_SHAPES.items()],
            "ffsync_track": [[*k, v] for k, v in
                             ffsync_cuda.LAUNCH_SHAPES.items()]}


def _final_stats(rx, n_samples, t0):
    """The run's stats JSON on stderr, its last line (``--debug 1`` logs
    the kernel launches and their shapes just before it)."""
    log.info("kernel launches %s", json.dumps(kernel_launches()))
    log.info("kernel shapes %s", json.dumps(kernel_shapes()))
    stats = rx.stats.as_dict()
    stats["samples"] = n_samples
    stats["elapsed_s"] = round(time.time() - t0, 3)
    print(json.dumps(stats), file=sys.stderr)


def _run_multi(args, rx):
    """Batched mode: N input files in lockstep -> N TS outputs."""
    outs = [open(pth, "wb") for pth in args.out_file.split(",")]
    n_samples = 0
    t0 = time.time()
    try:
        try:
            for chunk in iter_source_multi(args):
                n_samples += chunk.size
                for o, t in zip(outs, rx.receive(chunk, flush=False)):
                    if t.size:
                        o.write(t.tobytes())
        except KeyboardInterrupt:
            pass
        empty = np.empty((args.channels, 0), np.complex64)
        for o, t in zip(outs, rx.receive(empty, flush=True)):
            if t.size:
                o.write(t.tobytes())
    finally:
        for o in outs:
            o.close()
    _final_stats(rx, n_samples, t0)


def _run_single(args, r, rx, resampler):
    if args.out_fd is not None:
        out = os.fdopen(args.out_fd, "wb")
        close_out = True
    elif args.out_file == "-":
        out = sys.stdout.buffer
        close_out = False
    else:
        out = open(args.out_file, "wb")
        close_out = True

    last_log = time.time()
    n_samples = 0
    t0 = time.time()
    try:
        try:
            for chunk in iter_source(args, r.ratio):
                n_samples += chunk.size
                if resampler is not None:
                    chunk = resampler(chunk)
                ts = rx.receive(chunk, flush=False)
                if ts.size:
                    out.write(ts.tobytes())
                    out.flush()
                if (args.log_stats or args.log_all) and \
                        time.time() - last_log >= args.log_period:
                    nested = rx.get_stats(args.sym_rate)
                    if args.log_all:
                        nested["samples"] = n_samples
                        nested["samples_per_sec"] = (
                            n_samples / (time.time() - t0))
                        print(json.dumps(nested), file=sys.stderr)
                    else:
                        print(_log_simple(nested), file=sys.stderr)
                    last_log = time.time()
        except KeyboardInterrupt:
            pass
        tail = (resampler.flush() if resampler is not None
                else np.empty(0, np.complex64))
        ts = rx.receive(tail, flush=True)
        if ts.size:
            out.write(ts.tobytes())
    finally:
        if close_out:
            out.close()
    _final_stats(rx, n_samples, t0)


def main(argv=None) -> int:
    """Run the receiver on ``argv`` (``sys.argv[1:]`` when None); returns
    the exit code. The final stats JSON goes to stderr."""
    args = argument_parser().parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr,
        level=(logging.WARNING if args.debug == 0
               else logging.INFO if args.debug == 1 else logging.DEBUG),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    r = route(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"dvbs2-rx: {e} (run with --device cpu to decode "
                         "on the CPU)") from None
    log.info("route %s channels=%d device=%s", r.describe(), args.channels,
             device)
    rx, resampler = build(r, args.channels, device)

    extra = {"multistream": args.multistream, "sym_rate": args.sym_rate,
             "freq": args.freq}
    server = (start_mon_server(rx, args.mon_port, extra, args.sym_rate)
              if args.mon_server else None)
    try:
        if args.channels > 1:       # route() allows it on a stream engine
            _run_multi(args, rx)
        else:
            _run_single(args, r, rx, resampler)
    finally:
        if server:
            server.shutdown()
            server.server_close()
        if hasattr(rx, "close"):
            rx.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
