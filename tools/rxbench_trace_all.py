#!/usr/bin/env python3
"""A traced run of one benchmark cell that reports every per-layer metric
of ``BENCHMARK.json``, those whose ``workloads`` list leaves the cell out
too (the front end, FEC tail, idle share, copies and the eight glue
stages on a cell they do not list).

    PYTHONPATH=. python3 tools/rxbench_trace_all.py <cell> <seed> [seconds]

Prints the result line of ``rxbench/run.py --trace 1`` (a 50 s window by
default) with every metric it could read. It is a reading for PERF.md's
breakdown, not the benchmark's: the benchmark reports only the metrics
each cell is listed for.
"""

import json
import sys

from rxbench import run, spec


def main(argv):
    cell_name, seed = argv[0], int(argv[1])
    seconds = float(argv[2]) if len(argv) > 2 else 50.0
    bench = spec.load_bench(run.ROOT)
    cell = spec.cell(bench, cell_name, run.ROOT)
    cell.per_layer = bench["per_layer"]
    print(json.dumps(run.run_cell(cell, seed, seconds, trace=True)),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
