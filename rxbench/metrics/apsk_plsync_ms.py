"""``plsync_ms`` in the piloted 16APSK cell: the PL sync kernels' device
time per step (the pilot-mode statistics, the 16APSK max-log demap)."""
from rxbench.metrics.plsync_ms import PATTERNS, read  # noqa: F401

NAME = "apsk_plsync_ms"
UNIT = "ms"
LAYER = "PL sync + demap"
