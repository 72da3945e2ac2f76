"""PLS (physical layer signaling) parsing and PLFRAME geometry.

Mirrors the semantics of ``pls_info_t::parse`` (reference
``lib/pl_signaling.cc:19-61``): the 7-bit PLS value packs
``(modcod << 2) | (short_fecframe << 1) | has_pilots``.
"""

from dataclasses import dataclass

from .pl_defs import PLHEADER_LEN, SLOT_LEN, SLOTS_PER_PILOT_BLK, PILOT_BLK_LEN


@dataclass(frozen=True)
class PLSInfo:
    plsc: int
    modcod: int
    short_fecframe: bool
    has_pilots: bool
    dummy_frame: bool
    n_mod: int          # bits per constellation symbol (0 for dummy)
    n_slots: int        # 90-symbol slots in the XFECFRAME
    n_pilots: int       # number of 36-symbol pilot blocks
    plframe_len: int    # header + data + pilots
    payload_len: int    # data + pilots
    xfecframe_len: int  # data symbols only

    @property
    def constellation(self):
        return {2: "QPSK", 3: "8PSK", 4: "16APSK", 5: "32APSK"}.get(self.n_mod, "DUMMY")


def parse_pls(plsc: int) -> PLSInfo:
    modcod = plsc >> 2
    short_fecframe = bool(plsc & 0x2)
    has_pilots = bool(plsc & 0x1)
    dummy_frame = modcod == 0
    has_pilots = has_pilots and not dummy_frame

    if 1 <= modcod <= 11:
        n_mod, n_slots = 2, 360
    elif 12 <= modcod <= 17:
        n_mod, n_slots = 3, 240
    elif 18 <= modcod <= 23:
        n_mod, n_slots = 4, 180
    elif 24 <= modcod <= 28:
        n_mod, n_slots = 5, 144
    else:
        n_mod, n_slots = 0, 36  # dummy frame

    if short_fecframe and not dummy_frame:
        n_slots >>= 2

    n_pilots = ((n_slots - 1) >> 4) if has_pilots else 0
    plframe_len = (n_slots + 1) * SLOT_LEN + PILOT_BLK_LEN * n_pilots
    payload_len = plframe_len - PLHEADER_LEN
    xfecframe_len = n_slots * SLOT_LEN

    return PLSInfo(
        plsc=plsc,
        modcod=modcod,
        short_fecframe=short_fecframe,
        has_pilots=has_pilots,
        dummy_frame=dummy_frame,
        n_mod=n_mod,
        n_slots=n_slots,
        n_pilots=n_pilots,
        plframe_len=plframe_len,
        payload_len=payload_len,
        xfecframe_len=xfecframe_len,
    )


def make_pls(modcod: int, short_fecframe: bool, has_pilots: bool) -> int:
    return ((modcod & 0x1F) << 2) | (int(bool(short_fecframe)) << 1) | int(bool(has_pilots))


def pls_filter(*pls_values):
    """Build the 128-entry boolean PLS filter (True = frame accepted)."""
    enabled = [False] * 128
    for v in pls_values:
        enabled[int(v)] = True
    return enabled
