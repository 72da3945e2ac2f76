"""Step glue in the ``frontend`` stage (``StreamReceiver._frontend``: the
PyTorch operators around the front end's kernels), device time per step."""

from rxbench.metrics import _stages

NAME = "glue_frontend_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "frontend")
