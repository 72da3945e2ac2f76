"""Input samples (every channel) of the calls whose outputs reached host
memory inside the window, over the window's seconds, in millions."""

NAME = "rx_msps"
UNIT = "Msps"


def read(window):
    return window.landed * window.samples_per_call / window.seconds / 1e6
