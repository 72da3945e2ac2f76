"""Parameter validation/translation (reference ``python/dvbs2rx/params.py``).

Copy of ``dvbs2rx_tpu/utils/params.py`` on the port's own ``spec``.

String-level user parameters -> validated framework configuration, plus the
PLS helpers the reference exposes: ``dvbs2_pls`` (params.py:197), the 64-bit
``pls_filter`` bitmask pair (params.py:233), and the ``pl_info`` frame
geometry calculator (params.py:260).
"""

from ..spec.fec_params import (
    DVBS2_MODCODS,
    MODCOD_NUMBERS,
    ROLLOFFS,
    get_fec_info,
    rate_enum,
)
from ..spec.pls import make_pls, parse_pls

FRAME_SIZES = ("normal", "short", "medium")
STANDARDS = ("DVB-S2", "DVB-S2X", "DVB-T2")


def validate(standard="DVB-S2", frame_size="normal", modcod="qpsk1/4",
             rolloff=0.2, pilots=False, sps=2):
    """Validate string parameters; raises ValueError with a specific message."""
    if standard not in STANDARDS:
        raise ValueError(f"Unsupported standard {standard!r}")
    if frame_size not in FRAME_SIZES:
        raise ValueError(f"Unsupported frame size {frame_size!r}")
    if modcod.lower() not in MODCOD_NUMBERS:
        raise ValueError(f"Unsupported MODCOD {modcod!r}")
    if standard == "DVB-S2" and rolloff not in ROLLOFFS[:3]:
        raise ValueError(f"Rolloff {rolloff} requires DVB-S2X")
    if rolloff not in ROLLOFFS:
        raise ValueError(f"Unsupported rolloff {rolloff}")
    if sps < 2 or int(sps) != sps:
        raise ValueError("Samples per symbol must be an integer >= 2")
    num = MODCOD_NUMBERS[modcod.lower()]
    const, rate = DVBS2_MODCODS[num]
    rate_enum(rate, frame_size)  # raises if the combination is invalid
    return True


def translate(modcod, frame_size="normal", pilots=False):
    """Human MODCOD string -> (constellation, code rate, FECInfo, PLS)."""
    num = MODCOD_NUMBERS[modcod.lower()]
    const, rate = DVBS2_MODCODS[num]
    fec = get_fec_info(frame_size, rate)
    pls = make_pls(num, frame_size == "short", pilots)
    return const, rate, fec, pls


def dvbs2_pls(modcod, short_fecframe, pilots):
    """PLS value: (modcod << 2) | (short << 1) | pilots."""
    num = modcod if isinstance(modcod, int) else MODCOD_NUMBERS[modcod.lower()]
    return make_pls(num, short_fecframe, pilots)


def pls_filter(*pls_values):
    """(u64_lo, u64_hi) bitmask pair over the 128 PLS values (reference
    params.py:233-257: bit i of the pair enables PLS i)."""
    lo = hi = 0
    for v in pls_values:
        v = int(v)
        if not 0 <= v < 128:
            raise ValueError("PLS values must be within [0, 128)")
        if v < 64:
            lo |= 1 << v
        else:
            hi |= 1 << (v - 64)
    return lo, hi


def pl_info(modcod, short_fecframe=False, pilots=False):
    """PLFRAME geometry dict (reference params.py:260-320)."""
    info = parse_pls(dvbs2_pls(modcod, short_fecframe, pilots))
    return {
        "pls": info.plsc,
        "modcod": info.modcod,
        "constellation": info.constellation,
        "n_mod": info.n_mod,
        "n_slots": info.n_slots,
        "n_pilots": info.n_pilots,
        "plframe_len": info.plframe_len,
        "payload_len": info.payload_len,
        "xfecframe_len": info.xfecframe_len,
        "dummy": info.dummy_frame,
    }
