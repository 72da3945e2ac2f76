"""``ldpc_ms`` in the piloted 16APSK cell: the LDPC kernel's device time
per step (the rate-3/4 code, several iterations a frame)."""
from rxbench.metrics.ldpc_ms import PATTERNS, read  # noqa: F401

NAME = "apsk_ldpc_ms"
UNIT = "ms"
LAYER = "FEC"
