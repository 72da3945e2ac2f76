"""Run one cell of the benchmark of ``dvbs2rx_tpu_torch`` once.

    python3 rxbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up: the traffic ring from the seed (``stimulus``), the receiver
the configuration names, primed on the ring (``drivers``), warm-up calls
(the kernel build on a checkout's first run, the CUDA graph's capture).
Then the timed window: a closed loop with at most ``in_flight`` calls on
the device, every output of every call copied into pinned host memory,
the landing time stamped by a reader thread (``landing``). After the
window: the peak device memory, the receiver freed, the comparison with
the reference (``checker``), and with ``--trace 1`` the per-layer
metrics of the profiled segments (``trace``, ``metrics/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed`` (FECFRAMEs), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``limits`` (each number compared
beside its limit, also the last lines of standard error). Without the
cards the cell asks for, or with JAX or the JAX package loaded by the end,
it prints no result and exits non-zero.

``--control`` (not a cell's run) puts the configuration's control in
the program's place: the plain reference in the precision below the
configuration's, so the check has to come out false. ``--fault <name>``
(not a cell's run either) runs the program with one of the
configuration's ``faults`` overrides.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "dvbs2rx_tpu"}


@dataclass
class Window:
    seconds: float
    landed: int
    samples_per_call: int
    latencies_s: object
    setup_s: float


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def _card(dev):
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed, seconds, trace=False, device="cuda",
             control=False, fault=None, rx_fault=None):
    """One run of ``cell`` (``spec.Cell``); returns the result record.
    ``fault`` wraps the driver (a test's planted fault); ``rx_fault`` names
    one of the configuration's ``faults``."""
    import torch

    from rxbench import spec
    from rxbench.checker import Checker
    from rxbench.landing import LandingPool
    from rxbench.stimulus import Stimulus
    from rxbench.trace import Segments, TraceView

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", 0)
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    config, traffic = cell.config, cell.traffic
    stim = Stimulus(config, traffic, seed, dev)
    over = config["faults"][rx_fault]["rx"] if rx_fault else None
    surface = spec.driver(config["driver"])
    drv = surface.Driver(config, traffic, stim, dev, over)
    stim.wave = None                        # the driver holds its ring
    if fault is not None:
        drv = fault(drv)
    n_warm = traffic["warmup_calls"]
    checker = Checker(drv, surface.LIMITS, traffic, seed, n_warm)
    pool = LandingPool(dev, traffic["in_flight"], checker.on_land)

    def submit(i, info=None, snap=False):
        pool.wait_room()
        t = time.perf_counter()
        pool.deliver(i, t, drv.call(i, snap), info)

    for i in range(n_warm - 1):
        submit(i)
    prof = None
    if trace:
        prof = Segments(traffic["profile"]["segments"],
                        traffic["profile"]["calls"],
                        str(BUILD / "rxbench_trace.json"))
        prof.warm(lambda: (submit(n_warm - 1), pool.drain()))
    else:
        submit(n_warm - 1)
    pool.drain()
    if cuda:
        torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    setup_s = t0 - T_START
    t_end = t0 + seconds
    if prof is not None:
        prof.schedule(t0, seconds)
    i = n_warm
    while time.perf_counter() < t_end:
        if prof is not None and prof.due(time.perf_counter()):
            pool.drain()
            prof.start()
        profiled = prof is not None and prof.active
        snap = not profiled and checker.snap_due(
            (time.perf_counter() - t0) / seconds)
        submit(i, {"profiled": True} if profiled else None, snap)
        if profiled and prof.count(i):
            pool.drain()
            if cuda:
                torch.cuda.synchronize(dev)
            prof.stop(drv.steps_per_call)
        i += 1
    pool.drain()
    pool.close()
    if prof is not None and prof.active:
        prof.stop(drv.steps_per_call)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    geometry = drv.geometry()
    samples_per_call = drv.samples_per_call
    drv.close()
    del pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    landed, lat = checker.window(t_end)
    win = Window(seconds, landed, samples_per_call, lat, setup_s)
    check = checker.finish(stim, control)
    counters = checker.counters
    del drv, checker, stim
    device_rec = dict(_card(dev), memory_peak_bytes=int(peak))
    result = {"correct": check["correct"], "attempted": check["attempted"],
              "failed": check["failed"]}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = spec.end_to_end(m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        with open(Path(__file__).resolve().parent / "peaks.json") as f:
            peaks = json.load(f)["cards"].get(device_rec["kind"])
        view = TraceView(prof.parsed, cell.patterns, geometry,
                         counters, peaks)
        for m in cell.per_layer:
            value = spec.metric(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_rec["busy_s"] = view.busy_us / 1e6
        device_rec["window_s"] = view.span_us / 1e6
        device_rec["steps_traced"] = view.steps
        if cuda:
            device_rec["power_limit"] = _power_limit()
        result["breakdown"] = view.breakdown()
    result["metrics"] = metrics
    result["device"] = device_rec
    result["checked_frames"] = check["checked"]
    result["channels_flagged"] = check["channels_flagged"]
    result["channels_wrong"] = check["channels_wrong"]
    result["calls"] = {"warm": n_warm, "window": i - n_warm,
                       "landed_in_window": landed}
    result["limits"] = check["limits"]
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="the configuration's control in the program's "
                    "place (not a cell's run)")
    ap.add_argument("--fault", default=None,
                    help="run one of the configuration's faults (not a "
                    "cell's run)")
    args = ap.parse_args(argv)

    import torch

    from rxbench import spec

    bench = spec.load_bench(ROOT)
    cell = spec.cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available():
        print("rxbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"rxbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      control=args.control, rx_fault=args.fault)
    bad = forbidden_modules()
    if bad:
        print(f"rxbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, v in result["limits"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
