"""Output delivery: the copies of every output from the device into
pinned host memory, device time per step."""

NAME = "fetch_ms"
UNIT = "ms"
LAYER = "output delivery"
PATTERNS = ()


def read(view):
    us = view.dtoh_us()
    return view.per_step_ms(us) if us else None
