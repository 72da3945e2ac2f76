"""dvbs2-tx: DVB-S2 transmitter CLI of the PyTorch/CUDA port (MPEG TS in ->
IQ samples out).

    python -m dvbs2rx_tpu_torch.apps.dvbs2_tx --in-file in.ts \\
        --out-file iq.fc32 --modcod qpsk1/2 --frame-size short --snr 12

Counterpart of ``apps/dvbs2-tx``, with its options, defaults and messages,
on the port's own transmitter (``tx.Transmitter``, ``StreamingChannel``):
reads TS packets, produces a pulse-shaped DVB-S2 waveform, optionally with
channel impairments (AWGN at --snr, static --freq-offset and --phase) for
loopback tests. The TS->IQ path streams: input is consumed in whole-packet
chunks with BB framing, pulse-shape FIR and channel state carried across
chunks, so pipes, ``--in-repeat`` and ``--out-real-time`` work. Fractional
oversampling ratios go through the transmitter's arbitrary resampler. The
transmitter is numpy on the host; it needs no card.
"""

import argparse
import os
import sys
import time

import numpy as np

from .. import __version__
from ..io.iq import fc32_to_u8
from ..tx import Transmitter, TxConfig
from ..tx.transmitter import StreamingChannel
from .dvbs2_rx import eng_float


def argument_parser():
    p = argparse.ArgumentParser(
        prog="dvbs2-tx", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-v", "--version", action="version",
                   version=f"dvbs2rx_tpu_torch {__version__}")

    src = p.add_argument_group("Source Options")
    src.add_argument("--source", choices=["file", "fd"], default="file")
    src.add_argument("--in-file", default="-", help="input TS file ('-' = stdin)")
    src.add_argument("--in-fd", type=int, default=None,
                     help="input file descriptor (implies --source=fd)")
    src.add_argument("--in-repeat", action="store_true",
                     help="read repeatedly from the input file")

    snk = p.add_argument_group("Sink Options")
    snk.add_argument("--sink", choices=["file", "fd"], default="file")
    snk.add_argument("--out-file", default="-", help="output IQ file ('-' = stdout)")
    snk.add_argument("--out-fd", type=int, default=None,
                     help="output file descriptor (implies --sink=fd)")
    snk.add_argument("--out-iq-format", "--out-format", dest="out_iq_format",
                     choices=["fc32", "u8"], default="fc32")
    snk.add_argument("--out-real-time", action="store_true",
                     help="throttle the output to the sample rate")
    snk.add_argument("--fullscale", "--u8-scale", dest="fullscale",
                     type=float, default=0.25,
                     help="amplitude scale for u8 output (headroom for RRC "
                          "peaks, like the reference's SDR full-scale tap "
                          "scaling, apps/dvbs2-tx:38-82; default -12 dBFS)")

    rates = p.add_argument_group("Rate Options")
    rates.add_argument("--samp-rate", type=eng_float, default=None,
                       help="sampling rate in samples/second")
    rates.add_argument("-s", "--sym-rate", type=eng_float, default=1e6,
                       help="symbol rate in bauds")
    rates.add_argument("--sps", type=float, default=None,
                       help="oversampling ratio directly (overrides rates; "
                       "fractional ratios use the arbitrary resampler)")

    mod = p.add_argument_group("DVB-S2 Options")
    mod.add_argument("-m", "--modcod", default="qpsk1/4",
                     help="e.g. qpsk1/2, 8psk3/5")
    mod.add_argument("-f", "--frame-size", choices=["normal", "short"],
                     default="normal")
    mod.add_argument("--pilots", action="store_true")
    mod.add_argument("-r", "--rolloff", type=float, default=0.2,
                     choices=[0.35, 0.25, 0.2, 0.15, 0.1, 0.05],
                     help="rolloff factor (0.15/0.1/0.05 are DVB-S2X)")
    mod.add_argument("--gold-code", type=int, default=0)
    mod.add_argument("--rrc-delay", type=int, default=25)

    chan = p.add_argument_group("Channel Simulation Options")
    chan.add_argument("--snr", type=float, default=None,
                      help="Es/N0 in dB for AWGN simulation")
    chan.add_argument("--freq-offset", type=float, default=0.0,
                      help="normalized CFO (fraction of the sample rate)")
    chan.add_argument("--phase", type=float, default=0.0,
                      help="static phase offset (radians)")
    chan.add_argument("--seed", type=int, default=0)
    return p


def _read_packets(reader, chunk_pkts, pkt=188):
    """Whole-packet chunks from ``reader(n)``: a read that ends inside a
    packet carries the packet's bytes into the next read."""
    pending = b""
    while True:
        b = reader(chunk_pkts * pkt)
        if not b:
            break
        b = pending + b
        usable = len(b) - (len(b) % pkt)
        pending = b[usable:]
        if usable:
            yield np.frombuffer(b[:usable], dtype=np.uint8)


def iter_ts(args, chunk_pkts=1024):
    """Yield whole-packet TS chunks per the source/repeat flags."""
    if args.in_fd is not None:
        yield from _read_packets(lambda n: os.read(args.in_fd, n), chunk_pkts)
        return
    if args.in_file == "-":
        yield from _read_packets(sys.stdin.buffer.read, chunk_pkts)
        return
    while True:
        with open(args.in_file, "rb") as f:
            yield from _read_packets(f.read, chunk_pkts)
        if not args.in_repeat:
            return


def main(argv=None) -> int:
    """Run the transmitter on ``argv`` (``sys.argv[1:]`` when None);
    returns the exit code (1 when no complete TS packet arrived)."""
    args = argument_parser().parse_args(argv)

    # Fractional oversampling ratios are served by the polyphase arbitrary
    # resampler, mirroring the reference (apps/dvbs2-tx:638-686).
    if args.sps is not None:
        sps = args.sps
    elif args.samp_rate is not None:
        sps = args.samp_rate / args.sym_rate
    else:
        sps = 2
    if sps <= 1:
        raise SystemExit(f"samp-rate/sym-rate = {sps:g} must exceed 1")
    sps = int(sps) if float(sps).is_integer() else sps
    samp_rate = args.samp_rate if args.samp_rate else args.sym_rate * sps

    cfg = TxConfig(
        modcod=args.modcod,
        frame_size=args.frame_size,
        pilots=args.pilots,
        rolloff=args.rolloff,
        sps=sps,
        gold_code=args.gold_code,
        rrc_delay=args.rrc_delay,
    )
    tx = Transmitter(cfg)
    channel = (
        StreamingChannel(args.snr, sps, args.freq_offset, args.phase, args.seed)
        if (args.snr is not None or args.freq_offset or args.phase)
        else None
    )

    if args.out_fd is not None:
        out = os.fdopen(args.out_fd, "wb")
        close_out = True
    elif args.out_file == "-":
        out = sys.stdout.buffer
        close_out = False
    else:
        out = open(args.out_file, "wb")
        close_out = True

    def emit(iq):
        if iq.size == 0:
            return 0
        if channel is not None:
            iq = channel(iq)
        if args.out_iq_format == "u8":
            out.write(fc32_to_u8(iq * args.fullscale / 0.9).tobytes())
        else:
            out.write(np.asarray(iq, np.complex64).tobytes())
        out.flush()
        return iq.size

    n_pkts = 0
    n_samples = 0
    t0 = time.time()
    try:
        try:
            for chunk in iter_ts(args):
                n_pkts += chunk.size // 188
                n_samples += emit(tx.pulse_shape_stream(tx.modulate_ts(chunk)))
                if args.out_real_time:
                    ahead = n_samples / samp_rate - (time.time() - t0)
                    if ahead > 0:
                        time.sleep(ahead)
        except (KeyboardInterrupt, BrokenPipeError):
            pass
        else:
            n_samples += emit(tx.pulse_shape_flush())
    finally:
        if close_out:
            out.close()
    if n_pkts == 0:
        print("dvbs2-tx: no complete TS packets on input", file=sys.stderr)
        return 1
    print(
        f"dvbs2-tx: {n_pkts} TS packets -> {n_samples} IQ samples "
        f"({cfg.constellation} {cfg.rate}, {args.frame_size} FECFRAME, "
        f"pilots={'on' if args.pilots else 'off'})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
