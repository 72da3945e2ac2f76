"""FEC, LDPC: the layered decoder (``ops/ldpc_cuda.py``), device time per
step."""

NAME = "ldpc_ms"
UNIT = "ms"
LAYER = "FEC"
PATTERNS = ("ldpc*",)


def read(view):
    us = view.kernel_us(PATTERNS)
    return view.per_step_ms(us) if us else None
