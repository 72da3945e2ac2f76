"""Step glue in the ``plsync`` stage (the lane set-up around the PL sync
kernels (starts, ``expand``, ``repeat_interleave``) and the lane program's
own operators), device time per step."""

from rxbench.metrics import _stages

NAME = "glue_plsync_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "plsync")
