"""The LDPC kernel's share of its roofline in the piloted 16APSK cell, by
operations at the work the decoder did, whatever implements it: per frame
360 x (the table's data edges + 2 q) edges (EN 302 307-1's rate-3/4
normal code, table S2_B7: 360 x (540 + 90) = 226,800), 17 int32 steps an
edge for each iteration a frame ran (the program's ``ldpc_frame_iters``)
and 3 for each converged frame's passing parity check
(``ldpc_converged``), over the profiled calls, at the card's int32
instruction rate, over ``apsk_ldpc_ms``'s device time of those calls.
None unless the geometry is that code's (n_ldpc 64,800, 16APSK), or
without the counters."""

import functools

from rxbench.metrics.ldpc_ms import PATTERNS
from rxbench.txref.ldpc_tables import get_code

NAME = "apsk_ldpc_roofline_pct"
UNIT = "%"
LAYER = "FEC"
TABLE = "S2_B7"
OPS_ITER, OPS_CHECK = 17, 3         # int32 steps an edge: update, check


@functools.lru_cache(maxsize=1)
def frame_edges():
    code = get_code(TABLE)
    return code.M * (sum(len(a) for a in code.block_addr) + 2 * code.q)


def ops(view):
    iters = view.counters.get("stats.ldpc_frame_iters")
    conv = view.counters.get("stats.ldpc_converged")
    if iters is None or conv is None:
        return None
    return frame_edges() * (OPS_ITER * iters + OPS_CHECK * conv)


def read(view):
    g = view.geometry
    if g.get("n_ldpc") != 64_800 or g.get("n_mod") != 4 or not view.peaks:
        return None
    us = view.kernel_us(PATTERNS)
    n = ops(view)
    if not us or n is None:
        return None
    return 100.0 * (n / view.peaks["int32_ops_per_s"]) / (us * 1e-6)
