"""Step glue in the ``inputs`` stage (the call's copies of state and blocks
into the graph's static buffers (outside the graph), and each step's input),
device time per step."""

from rxbench.metrics import _stages

NAME = "glue_inputs_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "inputs")
