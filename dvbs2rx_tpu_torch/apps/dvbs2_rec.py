"""dvbs2-rec: record/convert IQ streams into SigMF recordings, the port's
counterpart of ``apps/dvbs2-rec``.

    python -m dvbs2rx_tpu_torch.apps.dvbs2_rec --in-file iq.fc32 \\
        --out capture --modcod qpsk1/2 --frame-size short

Captures an IQ stream (file or stdin) into a SigMF pair (``.sigmf-data`` +
``.sigmf-meta``) with the DVB-S2 extension metadata of the reference's
``docs/dvbs2.sigmf-ext.md`` (modcod, frame size, pilots, rolloff), so
captures can be replayed through ``dvbs2_rx`` later. Host only: it needs no
card.
"""

import argparse
import datetime
import json
import sys

import numpy as np

from .. import __version__
from ..io.iq import read_iq

RECORDER = "dvbs2rx_tpu_torch dvbs2_rec"


def argument_parser():
    p = argparse.ArgumentParser(prog="dvbs2-rec", description=__doc__)
    p.add_argument("-v", "--version", action="version",
                   version=f"dvbs2rx_tpu_torch {__version__}")
    p.add_argument("--in-file", default="-", help="input IQ stream ('-' = stdin)")
    p.add_argument("--iq-format", "--in-format", dest="iq_format",
                   choices=["fc32", "u8"], default="fc32")
    p.add_argument("--out", required=True, help="output basename (no extension)")
    p.add_argument("--samp-rate", type=float, default=2e6)
    p.add_argument("--sym-rate", type=float, default=None,
                   help="symbol rate in bauds (recorded as dvbs2 metadata)")
    p.add_argument("--freq", "--frequency", dest="freq", type=float, default=0.0)
    p.add_argument("--modcod", default=None)
    p.add_argument("--frame-size", default=None)
    p.add_argument("--pilots", action="store_true")
    p.add_argument("--rolloff", type=float, default=None)
    p.add_argument("--gold-code", type=int, default=0)
    p.add_argument("--description", default="")
    p.add_argument("--author", default="",
                   help="recording author for the SigMF metadata")
    p.add_argument("--hardware", default="",
                   help="capture hardware description for the SigMF metadata")
    return p


def main(argv=None) -> int:
    """Record ``argv``'s input (``sys.argv[1:]`` when None); returns the
    exit code."""
    args = argument_parser().parse_args(argv)

    iq = read_iq(args.in_file, args.iq_format)
    data_path = args.out + ".sigmf-data"
    meta_path = args.out + ".sigmf-meta"
    iq.astype(np.complex64).tofile(data_path)

    capture = {
        "core:sample_start": 0,
        "core:frequency": args.freq,
        "core:datetime": datetime.datetime.now(datetime.timezone.utc).isoformat(),
    }
    annotation = {"core:sample_start": 0, "core:sample_count": int(iq.size)}
    dvbs2 = {}
    if args.modcod:
        dvbs2["dvbs2:modcod"] = args.modcod
    if args.frame_size:
        dvbs2["dvbs2:fecframe_size"] = args.frame_size
    if args.rolloff is not None:
        dvbs2["dvbs2:rolloff"] = args.rolloff
    dvbs2["dvbs2:pilots"] = bool(args.pilots)
    dvbs2["dvbs2:gold_code"] = args.gold_code
    if args.sym_rate is not None:
        dvbs2["dvbs2:symbol_rate"] = args.sym_rate
    annotation.update(dvbs2)

    meta = {
        "global": {
            "core:datatype": "cf32_le",
            "core:sample_rate": args.samp_rate,
            "core:version": "1.0.0",
            "core:description": args.description,
            "core:author": args.author,
            "core:hw": args.hardware,
            "core:recorder": RECORDER,
        },
        "captures": [capture],
        "annotations": [annotation],
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    print(
        f"dvbs2-rec: wrote {iq.size} samples -> {data_path} + {meta_path}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
