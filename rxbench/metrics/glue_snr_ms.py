"""Step glue in the ``snr`` stage (``_snr_refine_frames`` and the refined N0),
device time per step."""

from rxbench.metrics import _stages

NAME = "glue_snr_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "snr")
