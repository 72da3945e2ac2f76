from .transmitter import Transmitter, TxConfig, awgn_channel  # noqa: F401
