"""The frozen transmitter against the port's, at short frames: the same
BBFRAMEs, PLFRAME symbols and RRC taps."""

import numpy as np
import pytest

from dvbs2rx_tpu_torch.tx import Transmitter as PortTx
from dvbs2rx_tpu_torch.tx import TxConfig as PortCfg
from dvbs2rx_tpu_torch.tx.vcm import VCMTransmitter as PortVCM
from rxbench.txref.transmitter import Transmitter, TxConfig
from rxbench.txref.vcm import VCMTransmitter


def _packets(n, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, (n, 188), dtype=np.uint8)
    pk[:, 0] = 0x47
    return pk.reshape(-1)


@pytest.mark.parametrize("modcod,pilots", [("qpsk1/2", False),
                                           ("qpsk1/2", True),
                                           ("8psk3/5", True)])
def test_ccm_frames_and_symbols(modcod, pilots):
    ts = _packets(60, 1)
    ours = Transmitter(TxConfig(modcod=modcod, frame_size="short",
                                pilots=pilots))
    port = PortTx(PortCfg(modcod=modcod, frame_size="short", pilots=pilots))
    a, b = ours.bbframes(ts), port.bbframes(ts)
    assert a.shape[0] >= 3 and np.array_equal(a, b)
    for f in a[:3]:
        assert np.array_equal(ours.plframe(ours.xfecframe(
            ours.fecframe_bits(f))), port.plframe(port.xfecframe(
                port.fecframe_bits(f))))
    assert np.array_equal(ours.rrc_taps(), port._rrc_taps())


def test_vcm_stream():
    ts = _packets(60, 2)
    cfgs = [("qpsk1/2", True), ("8psk3/5", True)]
    ours = VCMTransmitter([TxConfig(modcod=m, frame_size="short", pilots=p)
                           for m, p in cfgs])
    port = PortVCM([PortCfg(modcod=m, frame_size="short", pilots=p)
                    for m, p in cfgs])
    a = ours.modulate_ts(ts, [0, 1])
    assert a.size > 0 and np.array_equal(a, port.modulate_ts(ts, [0, 1]))
