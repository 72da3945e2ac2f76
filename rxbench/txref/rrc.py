"""Root-raised-cosine filter design (GNU Radio ``firdes`` compatible).

Used for the Tx pulse shaping and the Rx polyphase matched-filter bank
(reference ``lib/symbol_sync_cc_impl.cc:73-132`` relies on
``filter::firdes::root_raised_cosine``). Taps are normalized so the DC gain
equals ``gain``, matching GNU Radio's convention.
"""

import numpy as np


def root_raised_cosine(gain, sampling_freq, symbol_rate, alpha, ntaps):
    ntaps = int(ntaps) | 1  # force odd length
    spb = sampling_freq / symbol_rate  # samples per bit/symbol
    taps = np.zeros(ntaps, dtype=np.float64)
    scale = 0.0
    for i in range(ntaps):
        xindx = i - ntaps // 2
        x1 = np.pi * xindx / spb
        x2 = 4.0 * alpha * xindx / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if xindx != 0:
                num = np.cos((1 + alpha) * x1) + np.sin((1 - alpha) * x1) / (
                    4 * alpha * xindx / spb
                )
            else:
                num = np.cos((1 + alpha) * x1) + (1 - alpha) * np.pi / (4 * alpha)
            den = x3 * np.pi
        else:
            if alpha == 1:
                taps[i] = -1.0
                scale += taps[i]
                continue
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (
                np.sin(x2) * (1 + alpha) * np.pi
                - np.cos(x3) * ((1 - alpha) * np.pi * spb) / (4 * alpha * xindx)
                + np.sin(x3) * spb * spb / (4 * alpha * xindx * xindx)
            )
            den = -32.0 * np.pi * alpha * alpha * xindx / spb
        taps[i] = 4 * alpha * num / den
        scale += taps[i]
    return (taps * gain / scale).astype(np.float32)


def polyphase_rrc_bank(sps, rolloff, rrc_delay, n_subfilt):
    """Polyphase decomposition of an RRC matched filter.

    Designs an RRC at oversampling ``n_subfilt * sps`` and splits it into
    ``n_subfilt`` phase-offset subfilters, each for oversampling ``sps``. The
    symbol timing loop selects the subfilter by the fractional offset mu, which
    fuses matched filtering, decimation, and interpolation into one dot product.

    Returns (bank, subfilt_len, subfilt_delay) where ``bank`` has shape
    (n_subfilt, subfilt_len) with taps already reversed for convolution-style
    inner products against a newest-last sample window.
    """
    poly_sps = n_subfilt * sps
    n_poly_taps = int(2 * poly_sps * rrc_delay) + 1
    taps = root_raised_cosine(n_subfilt, poly_sps, 1.0, rolloff, n_poly_taps)
    n_zero_pad = n_subfilt - (len(taps) % n_subfilt)
    taps = np.concatenate([taps, np.zeros(n_zero_pad, dtype=np.float32)])
    subfilt_len = len(taps) // n_subfilt
    bank = np.empty((n_subfilt, subfilt_len), dtype=np.float32)
    for i in range(n_subfilt):
        bank[i] = taps[i::n_subfilt]
    bank = bank[:, ::-1].copy()  # reversed taps
    subfilt_delay = (subfilt_len - 1) // 2
    return bank, subfilt_len, subfilt_delay
