"""PL sync and demap's share of its roofline: per frame demapped, its
payload symbols and headers read once, its int8 LLRs written once and the
symbols the SNR refinement reads written once (float32), at the card's HBM
rate, over ``plsync_ms``: every lane of the CCM step (channels x frames a
step), the headers of its frames and the next frame's, and one frame a
channel's corrected symbols.
"""

from rxbench.metrics import _roofline
from rxbench.metrics.plsync_ms import PATTERNS

NAME = "plsync_roofline_pct"
UNIT = "%"
LAYER = "PL sync + demap"
HDR = 90 * 8                                    # one PLHEADER, float32 IQ


def ccm_step_bytes(g):
    B = g["channels"] * g["frames_per_step"]
    return (B * g["payload_len"] * 8
            + g["channels"] * (g["frames_per_step"] + 1) * HDR
            + B * g["n_ldpc"] + g["channels"] * g["xfec_len"] * 8)


def read(view):
    us = view.kernel_us(PATTERNS)
    if not us or not view.steps:
        return None
    nbytes = view.steps * ccm_step_bytes(view.geometry)
    return _roofline.bytes_share(view, nbytes, us)
