"""PL sync and demap: PLHEADER phases, payload statistics, fine CFO,
demap to int8 LLRs (``parallel/batch.py`` lane program,
``ops/plsync_cuda.py``), device time per step."""

NAME = "plsync_ms"
UNIT = "ms"
LAYER = "PL sync + demap"
PATTERNS = ("plsync_*",)


def read(view):
    us = view.kernel_us(PATTERNS)
    return view.per_step_ms(us) if us else None
