"""Device busy time (the union of kernels, copies and fills) per step."""

NAME = "step_busy_ms"
UNIT = "ms"
LAYER = "device step"
PATTERNS = ()


def read(view):
    return view.per_step_ms(view.busy_us) if view.busy_us else None
