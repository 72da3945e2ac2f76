"""Process start to the first timed call: imports, the kernel build
(cached in the checkout after the first run), the stimulus, ``prime``,
graph capture and warm-up of the cell's own shapes."""

NAME = "setup_s"
UNIT = "s"


def read(window):
    return window.setup_s
