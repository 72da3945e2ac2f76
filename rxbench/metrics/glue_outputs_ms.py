"""Step glue in the ``outputs`` stage (the state casts, the statistics, and the
stacking over the call's steps with the final copy into the graph's state),
device time per step."""

from rxbench.metrics import _stages

NAME = "glue_outputs_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "outputs")
