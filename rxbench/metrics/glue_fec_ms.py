"""Step glue in the ``fec`` stage (``FECStage.lane_major`` around the LDPC and
BCH kernels (the byte packing) and ``packet_validity``'s descrambling XOR),
device time per step."""

from rxbench.metrics import _stages

NAME = "glue_fec_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = _stages.PATTERNS


def read(view):
    return _stages.read(view, "fec")
