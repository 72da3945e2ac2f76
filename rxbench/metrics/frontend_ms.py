"""Front end: AGC, rotate-and-append, O&M timing tracker, matched filter
(``ops/frontend_cuda.py``, ``ops/ffsync_cuda.py``, ``ops/fir_cuda.py``),
device time per step."""

NAME = "frontend_ms"
UNIT = "ms"
LAYER = "front end"
PATTERNS = ("frontend_*", "ffsync_*", "mf_segmented*")


def read(view):
    us = view.kernel_us(PATTERNS)
    return view.per_step_ms(us) if us else None
