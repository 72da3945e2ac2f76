"""Share of the traced span in which no kernel, copy or fill ran on the
device (1 - union of device intervals / span)."""

NAME = "device_idle_pct"
UNIT = "%"
LAYER = "device"
PATTERNS = ()


def read(view):
    if not view.span_us:
        return None
    return 100.0 * (1.0 - view.busy_us / view.span_us)
