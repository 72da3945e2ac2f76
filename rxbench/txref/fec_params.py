"""FEC configuration: (standard, frame size, code rate) -> BCH/LDPC geometry.

Data from ETSI EN 302 307-1 Tables 5a/5b (and the S2X/T2 counterparts),
extracted into ``_fec_table_gen.py``; parity with reference
``lib/fec_params.cc`` and ``python/dvbs2rx/defs.py``.
"""

from dataclasses import dataclass

from ._fec_table_gen import FEC_TABLE

# Human rate string -> canonical rate enum per frame size (defs.py:65-281).
_RATE_ENUMS = {
    "1/4": {"normal": "C1_4", "short": "C1_4"},
    "1/3": {"normal": "C1_3", "short": "C1_3", "medium": "C1_3_MEDIUM"},
    "2/5": {"normal": "C2_5", "short": "C2_5"},
    "1/2": {"normal": "C1_2", "short": "C1_2"},
    "3/5": {"normal": "C3_5", "short": "C3_5"},
    "2/3": {"normal": "C2_3", "short": "C2_3"},
    "3/4": {"normal": "C3_4", "short": "C3_4"},
    "4/5": {"normal": "C4_5", "short": "C4_5"},
    "5/6": {"normal": "C5_6", "short": "C5_6"},
    "8/9": {"normal": "C8_9", "short": "C8_9"},
    "9/10": {"normal": "C9_10"},
    "2/9": {"normal": "C2_9_VLSNR"},
    "13/45": {"normal": "C13_45"},
    "9/20": {"normal": "C9_20"},
    "90/180": {"normal": "C90_180"},
    "96/180": {"normal": "C96_180"},
    "11/20": {"normal": "C11_20"},
    "100/180": {"normal": "C100_180"},
    "104/180": {"normal": "C104_180"},
    "26/45": {"normal": "C26_45", "short": "C26_45"},
    "18/30": {"normal": "C18_30"},
    "28/45": {"normal": "C28_45"},
    "23/36": {"normal": "C23_36"},
    "116/180": {"normal": "C116_180"},
    "20/30": {"normal": "C20_30"},
    "124/180": {"normal": "C124_180"},
    "25/36": {"normal": "C25_36"},
    "128/180": {"normal": "C128_180"},
    "13/18": {"normal": "C13_18"},
    "132/180": {"normal": "C132_180"},
    "22/30": {"normal": "C22_30"},
    "135/180": {"normal": "C135_180"},
    "140/180": {"normal": "C140_180"},
    "7/9": {"normal": "C7_9"},
    "154/180": {"normal": "C154_180"},
    "1/5": {"medium": "C1_5_MEDIUM", "short": "C1_5_VLSNR"},
    "11/45": {"short": "C11_45", "medium": "C11_45_MEDIUM"},
    "4/15": {"short": "C4_15"},
    "14/45": {"short": "C14_45"},
    "7/15": {"short": "C7_15"},
    "8/15": {"short": "C8_15"},
    "32/45": {"short": "C32_45"},
}

# (framesize, rate_enum) -> LDPC QC table name (reference
# ``lib/ldpc_decoder_bb_impl.cc:104-307``; DVB-S2 selections shown, the T2
# alternates for C2_3 normal / C3_5 short are keyed with standard "DVB-T2").
LDPC_TABLE_MAP = {
    ("normal", "C1_4"): "S2_B1",
    ("normal", "C1_3"): "S2_B2",
    ("normal", "C2_5"): "S2_B3",
    ("normal", "C1_2"): "S2_B4",
    ("normal", "C3_5"): "S2_B5",
    ("normal", "C2_3"): "S2_B6",
    ("normal", "C3_4"): "S2_B7",
    ("normal", "C4_5"): "S2_B8",
    ("normal", "C5_6"): "S2_B9",
    ("normal", "C8_9"): "S2_B10",
    ("normal", "C9_10"): "S2_B11",
    ("normal", "C2_9_VLSNR"): "S2X_B1",
    ("normal", "C13_45"): "S2X_B2",
    ("normal", "C9_20"): "S2X_B3",
    ("normal", "C90_180"): "S2X_B11",
    ("normal", "C96_180"): "S2X_B12",
    ("normal", "C11_20"): "S2X_B4",
    ("normal", "C100_180"): "S2X_B13",
    ("normal", "C104_180"): "S2X_B14",
    ("normal", "C26_45"): "S2X_B5",
    ("normal", "C18_30"): "S2X_B22",
    ("normal", "C28_45"): "S2X_B6",
    ("normal", "C23_36"): "S2X_B7",
    ("normal", "C116_180"): "S2X_B15",
    ("normal", "C20_30"): "S2X_B23",
    ("normal", "C124_180"): "S2X_B16",
    ("normal", "C25_36"): "S2X_B8",
    ("normal", "C128_180"): "S2X_B17",
    ("normal", "C13_18"): "S2X_B9",
    ("normal", "C132_180"): "S2X_B18",
    ("normal", "C22_30"): "S2X_B24",
    ("normal", "C135_180"): "S2X_B19",
    ("normal", "C140_180"): "S2X_B20",
    ("normal", "C7_9"): "S2X_B10",
    ("normal", "C154_180"): "S2X_B21",
    ("short", "C1_4"): "S2_C1",
    ("short", "C1_3"): "S2_C2",
    ("short", "C2_5"): "S2_C3",
    ("short", "C1_2"): "S2_C4",
    ("short", "C3_5"): "S2_C5",
    ("short", "C2_3"): "S2_C6",
    ("short", "C3_4"): "S2_C7",
    ("short", "C4_5"): "S2_C8",
    ("short", "C5_6"): "S2_C9",
    ("short", "C8_9"): "S2_C10",
    ("short", "C11_45"): "S2X_C1",
    ("short", "C4_15"): "S2X_C2",
    ("short", "C14_45"): "S2X_C3",
    ("short", "C7_15"): "S2X_C4",
    ("short", "C8_15"): "S2X_C5",
    ("short", "C26_45"): "S2X_C6",
    ("short", "C32_45"): "S2X_C7",
    ("short", "C1_5_VLSNR_SF2"): "S2_C1",
    ("short", "C11_45_VLSNR_SF2"): "S2X_C1",
    ("short", "C1_5_VLSNR"): "S2_C1",
    ("short", "C4_15_VLSNR"): "S2X_C2",
    ("short", "C1_3_VLSNR"): "S2_C2",
    ("medium", "C1_5_MEDIUM"): "S2X_C8",
    ("medium", "C11_45_MEDIUM"): "S2X_C9",
    ("medium", "C1_3_MEDIUM"): "S2X_C10",
    # DVB-T2 alternates
    ("normal", "C2_3", "DVB-T2"): "T2_A3",
    ("short", "C3_5", "DVB-T2"): "T2_B3",
}

# DVB-S2 MODCOD number -> (constellation, rate string) (defs.py:283-312)
DVBS2_MODCODS = {
    1: ("QPSK", "1/4"), 2: ("QPSK", "1/3"), 3: ("QPSK", "2/5"),
    4: ("QPSK", "1/2"), 5: ("QPSK", "3/5"), 6: ("QPSK", "2/3"),
    7: ("QPSK", "3/4"), 8: ("QPSK", "4/5"), 9: ("QPSK", "5/6"),
    10: ("QPSK", "8/9"), 11: ("QPSK", "9/10"),
    12: ("8PSK", "3/5"), 13: ("8PSK", "2/3"), 14: ("8PSK", "3/4"),
    15: ("8PSK", "5/6"), 16: ("8PSK", "8/9"), 17: ("8PSK", "9/10"),
    18: ("16APSK", "2/3"), 19: ("16APSK", "3/4"), 20: ("16APSK", "4/5"),
    21: ("16APSK", "5/6"), 22: ("16APSK", "8/9"), 23: ("16APSK", "9/10"),
    24: ("32APSK", "3/4"), 25: ("32APSK", "4/5"), 26: ("32APSK", "5/6"),
    27: ("32APSK", "8/9"), 28: ("32APSK", "9/10"),
}

MODCOD_NUMBERS = {
    (const.lower() + rate): num for num, (const, rate) in DVBS2_MODCODS.items()
}

ROLLOFFS = (0.35, 0.25, 0.2, 0.15, 0.1, 0.05)  # last three are S2X only


@dataclass(frozen=True)
class FECInfo:
    framesize: str   # "normal" | "short" | "medium"
    rate: str        # human string, e.g. "1/2"
    rate_enum: str   # e.g. "C1_2"
    kbch: int
    nbch: int        # == kldpc
    t: int           # BCH error-correction capability
    nldpc: int
    ldpc_table: str

    @property
    def kldpc(self):
        return self.nbch


def rate_enum(rate: str, framesize: str) -> str:
    try:
        return _RATE_ENUMS[rate][framesize]
    except KeyError:
        raise ValueError(f"Unsupported rate {rate!r} for {framesize} FECFRAME")


def get_fec_info(framesize: str, rate: str, standard: str = "DVB-S2") -> FECInfo:
    """Look up FEC geometry by frame size and human rate string (e.g. "3/5")."""
    enum = rate_enum(rate, framesize)
    entry = FEC_TABLE[(framesize, enum)]
    key3 = (framesize, enum, standard)
    table = LDPC_TABLE_MAP.get(key3) or LDPC_TABLE_MAP[(framesize, enum)]
    return FECInfo(
        framesize=framesize,
        rate=rate,
        rate_enum=enum,
        kbch=entry["kbch"],
        nbch=entry["nbch"],
        t=entry["t"],
        nldpc=entry["nldpc"],
        ldpc_table=table,
    )
