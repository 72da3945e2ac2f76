"""The CPU rehearsals' overrides: the cell's loop at 2 channels and short
FECFRAMEs, with a short warm-up and a small sample."""

from rxbench import spec
from rxbench.run import ROOT

CCM = {"channels": 2, "rx": {"frame_size": "short", "fec_batch": 4},
       "tx": [{"modcod": "qpsk1/2", "frame_size": "short", "pilots": False}]}
CCM_TRAFFIC = {"warmup_calls": 2, "lock_steps": 8, "check_frames": 4096,
               "check_calls": 2, "profile": {"segments": 1, "calls": 1}}


def small_cell(workload, config_over=None, traffic_over=None):
    """The cell ``workload`` of BENCHMARK.json cut to a CPU rehearsal, with
    further overrides laid over it."""
    bench = spec.load_bench(ROOT)
    return spec.cell(bench, workload, ROOT, spec.merge(CCM, config_over),
                     spec.merge(CCM_TRAFFIC, traffic_over))
