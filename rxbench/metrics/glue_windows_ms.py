"""Step glue in the ``windows`` stage (the symbols of the step (tail and new)
and the frame windows (``_windows``)), device time per step."""

from rxbench.metrics import _stages

NAME = "glue_windows_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "windows")
