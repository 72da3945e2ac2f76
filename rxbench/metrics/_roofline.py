"""Shares of the published peaks (``rxbench/peaks.json``), shared by the
roofline metrics."""


def bytes_share(view, nbytes, us):
    """The least time ``nbytes`` take at the card's HBM rate, as a share of
    ``us`` (the layer's device time per step), in %; None without a peak
    for this card or without device time."""
    if view.peaks is None or not us:
        return None
    return 100.0 * (nbytes / view.peaks["hbm_bytes_per_s"]) / (us * 1e-6)
