"""``plsync_roofline_pct`` in the piloted 16APSK cell: the same byte count
at this geometry (payloads with pilots 17.0 MB, int8 LLRs 8.29 MB, frame
0's symbols 8.29 MB, headers 0.14 MB: 33.7 MB a step)."""
from rxbench.metrics.plsync_roofline_pct import PATTERNS, read  # noqa: F401

NAME = "apsk_plsync_roofline_pct"
UNIT = "%"
LAYER = "PL sync + demap"
