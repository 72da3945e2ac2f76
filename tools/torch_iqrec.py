#!/usr/bin/env python3
"""SigMF recording catalog and replay through the port's rx app.

    python tools/torch_iqrec.py list [dir]
    python tools/torch_iqrec.py replay <basename> [--out out.ts]
        [--measure-cpu] [extra dvbs2_rx args, e.g. --device cpu]

The counterpart of ``tools/iqrec.py`` (the reference's ``util/iqrec``) for
the PyTorch/CUDA port: ``list`` prints each ``*.sigmf-meta`` recording in a
directory with its size and DVB-S2 metadata; ``replay`` runs the recording
through ``python -m dvbs2rx_tpu_torch.apps.dvbs2_rx`` with the modcod,
frame size, pilots, rolloff and gold code of its annotation (recordings
from ``python -m dvbs2rx_tpu_torch.apps.dvbs2_rec``), on the card unless
``--device cpu`` is passed on. ``--measure-cpu`` samples the replay's
host-CPU utilization from ``/proc/<pid>/stat``.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cmd_list(args):
    metas = sorted(glob.glob(os.path.join(args.dir, "*.sigmf-meta")))
    if not metas:
        print("no SigMF recordings found")
        return 0
    for m in metas:
        with open(m) as f:
            meta = json.load(f)
        g = meta.get("global", {})
        ann = (meta.get("annotations") or [{}])[0]
        data = m[: -len(".sigmf-meta")] + ".sigmf-data"
        size = os.path.getsize(data) // 8 if os.path.exists(data) else 0
        print(
            f"{os.path.basename(m)[:-11]:30s} {size:>12d} samples  "
            f"fs={g.get('core:sample_rate', 0):.0f}  "
            f"modcod={ann.get('dvbs2:modcod', '?')} "
            f"frame={ann.get('dvbs2:fecframe_size', '?')} "
            f"pilots={ann.get('dvbs2:pilots', '?')}"
        )
    return 0


def replay_command(basename, out, extra):
    """The rx app's command line for a recording: the module, its in-file
    and out-file, the annotation's DVB-S2 options, then ``extra``."""
    with open(basename + ".sigmf-meta") as f:
        meta = json.load(f)
    ann = (meta.get("annotations") or [{}])[0]
    cmd = [sys.executable, "-m", "dvbs2rx_tpu_torch.apps.dvbs2_rx",
           "--in-file", basename + ".sigmf-data", "--out-file", out]
    if ann.get("dvbs2:modcod"):
        cmd += ["--modcod", str(ann["dvbs2:modcod"])]
    if ann.get("dvbs2:fecframe_size"):
        cmd += ["--frame-size", str(ann["dvbs2:fecframe_size"])]
    if ann.get("dvbs2:pilots"):
        cmd += ["--pilots"]
    if ann.get("dvbs2:rolloff"):
        cmd += ["--rolloff", str(ann["dvbs2:rolloff"])]
    if ann.get("dvbs2:gold_code"):
        cmd += ["--gold-code", str(ann["dvbs2:gold_code"])]
    return cmd + list(extra)


def _env():
    """The environment with the repo root on the module path, so the rx
    app's module resolves from any working directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def cmd_replay(args, extra):
    cmd = replay_command(args.basename, args.out, extra)
    print("+", " ".join(cmd), file=sys.stderr)
    if not args.measure_cpu:
        return subprocess.call(cmd, env=_env())
    proc = subprocess.Popen(cmd, env=_env())
    clk = os.sysconf("SC_CLK_TCK")
    samples, prev = [], None
    while proc.poll() is None:
        try:
            with open(f"/proc/{proc.pid}/stat") as f:
                parts = f.read().split()
            cpu_s = (int(parts[13]) + int(parts[14])) / clk
        except (OSError, IndexError, ValueError):
            break
        now = time.time()
        if prev is not None and now > prev[1]:
            samples.append(100.0 * (cpu_s - prev[0]) / (now - prev[1]))
        prev = (cpu_s, now)
        time.sleep(0.5)
    if samples:
        print(f"cpu%: avg {sum(samples) / len(samples):.1f} "
              f"peak {max(samples):.1f} over {len(samples)} samples",
              file=sys.stderr)
    return proc.wait()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list")
    p_list.add_argument("dir", nargs="?", default=".")
    p_rep = sub.add_parser("replay")
    p_rep.add_argument("basename")
    p_rep.add_argument("--out", default="-")
    p_rep.add_argument("--measure-cpu", action="store_true",
                       help="sample host-CPU utilization during replay")
    args, extra = ap.parse_known_args(argv)
    if args.cmd == "list":
        return cmd_list(args)
    return cmd_replay(args, extra)


if __name__ == "__main__":
    sys.exit(main())
