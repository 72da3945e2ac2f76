"""Step glue: device time that no layer metric's patterns claim (the
PyTorch operators of ``rx/stream.py``: lock, coarse-CFO and rotator
loops, SNR refinement, windows, slip metric; copies on the device),
copies to the host aside, per step."""

NAME = "glue_ms"
UNIT = "ms"
LAYER = "step glue"
PATTERNS = ()


def read(view):
    us = view.unmatched_us()
    return view.per_step_ms(us) if us else None
