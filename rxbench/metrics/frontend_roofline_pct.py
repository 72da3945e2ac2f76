"""Front end's share of its roofline: the bytes one step's inputs need,
whatever implements the layer (every channel's IQ block read once, the
matched filter's carried history read once, the symbols written once,
float32 pairs), at the card's HBM rate, over ``frontend_ms``."""

from rxbench.metrics import _roofline
from rxbench.metrics.frontend_ms import PATTERNS

NAME = "frontend_roofline_pct"
UNIT = "%"
LAYER = "front end"


def step_bytes(g):
    return g["channels"] * 8 * (g["n_in"] + g["history"] + g["n_out"])


def read(view):
    us = view.kernel_us(PATTERNS)
    if not us:
        return None
    return _roofline.bytes_share(view, step_bytes(view.geometry),
                                 us / view.steps)
