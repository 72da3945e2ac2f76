"""``step_busy_ms`` in the piloted 16APSK cell: device busy time per step."""
from rxbench.metrics.step_busy_ms import PATTERNS, read  # noqa: F401

NAME = "apsk_step_busy_ms"
UNIT = "ms"
LAYER = "device step"
