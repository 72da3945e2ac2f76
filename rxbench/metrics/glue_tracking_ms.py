"""Step glue in the ``tracking`` stage (the slip metric, lock, coarse-CFO and
rotator recurrences), device time per step."""

from rxbench.metrics import _stages

NAME = "glue_tracking_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "tracking")
