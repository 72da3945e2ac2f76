"""The benchmark's one traffic generator: a cyclic multi-channel IQ ring
made from ``--seed``, the configuration and a traffic file.

The frames are encoded once on the host by the frozen transmitter
(``rxbench.txref``): random TS packets -> BBFRAMEs -> BCH, LDPC, mapping,
PL framing. Each channel then carries its own seed-drawn order of those
frames (a permutation within each MODCOD of the configuration's schedule),
and on the device its own carrier phase, integer sample delay and noise.
The ring is cyclic over whole frames, so the receiver reads it round and
round without a seam: the pulse shaping is a circular convolution, and the
delay a circular shift.

Traffic keys read here: ``esn0_db``, ``ring_frames`` (frames a channel
carries before the ring repeats), ``pool_frames`` (distinct frames
encoded, ``ring_frames`` when absent; a channel's ring is
``ring_frames / pool_frames`` seed-drawn orders of the pool, so a long
ring of fresh noise costs no more encoding). Both are multiples of the
schedule's length.
"""

import numpy as np
import torch

from .txref.transmitter import TxConfig
from .txref.vcm import VCMTransmitter

TS_PACKET = 188


def tx_configs(config):
    """The configuration's transmitter list: one TxConfig per MODCOD."""
    rx = config["rx"]
    return [TxConfig(modcod=t["modcod"], frame_size=t["frame_size"],
                     pilots=t["pilots"], rolloff=rx["rolloff"], sps=rx["sps"],
                     rrc_delay=config["tx_rrc_delay"])
            for t in config["tx"]]


def encode_pool(config, ring_frames, rng):
    """Encode ``ring_frames`` frames following the configuration's
    ``schedule`` (indexes into its ``tx`` list, cycled). Returns (kinds
    (R,) int, bbframes: list of uint8 arrays (BB-scrambled, as the
    receiver delivers them), symbols: list of complex64 PLFRAMEs)."""
    schedule = list(config["schedule"])
    if ring_frames % len(schedule):
        raise ValueError("ring_frames must be a multiple of the schedule")
    vtx = VCMTransmitter(tx_configs(config))
    df_bytes = sum(vtx.txs[s].df_bytes for s in schedule)
    n_pkts = (ring_frames // len(schedule)) * df_bytes // TS_PACKET + 2
    pkts = rng.integers(0, 256, (n_pkts, TS_PACKET), dtype=np.uint8)
    pkts[:, 0] = 0x47
    frames = vtx.bbframes(pkts.reshape(-1), schedule)[:ring_frames]
    if len(frames) != ring_frames:
        raise RuntimeError("traffic generator under-filled the ring")
    kinds = np.array([k for k, _ in frames], np.int64)
    bbs = [bb for _, bb in frames]
    syms = [vtx.txs[k].plframe(vtx.txs[k].xfecframe(
        vtx.txs[k].fecframe_bits(bb))) for k, bb in frames]
    return kinds, bbs, syms, vtx.txs[0].rrc_taps()


class Stimulus:
    """The ring of one run.

    ``wave`` (C, N, 2) float32 on ``device``: channel c's cyclic IQ.
    ``order`` (C, R) int64: channel c's frame j is pool frame
    ``order[c, j]``; ``kinds`` (R,) the pool frames' MODCOD index;
    ``bbframes`` the pool frames' delivered bytes; ``frame_samples`` (R,)
    the samples of the ring's frame slots (equal for every channel)."""

    def __init__(self, config, traffic, seed, device):
        C = config["channels"]
        sps = config["rx"]["sps"]
        R = traffic["ring_frames"]
        P = traffic.get("pool_frames", R)
        if R % P:
            raise ValueError("ring_frames must be a multiple of pool_frames")
        rng = np.random.default_rng(seed)
        self.kinds, self.bbframes, syms, taps = encode_pool(config, P, rng)
        sched = np.asarray(config["schedule"])
        # channel c, slot j carries a frame of kind sched[j % len]: seed-
        # drawn permutations of the pool frames of that kind, one after
        # another
        slot_kind = sched[np.arange(R) % sched.size]
        order = np.empty((C, R), np.int64)
        for k in np.unique(slot_kind):
            pool_k = np.flatnonzero(self.kinds == k)
            slots = np.flatnonzero(slot_kind == k)
            for c in range(C):
                order[c, slots] = np.concatenate(
                    [rng.permutation(pool_k)
                     for _ in range(slots.size // pool_k.size)])
        self.order = order
        lens = np.array([s.size for s in syms], np.int64)
        slot_len = lens[order[0]]
        if not all((lens[order[c]] == slot_len).all() for c in range(C)):
            raise RuntimeError("slot lengths differ across channels")
        self.frame_samples = slot_len * sps
        N = int(slot_len.sum()) * sps
        self.n_samples = N
        phase = rng.uniform(0.0, 2 * np.pi, C)
        delay = rng.integers(0, N, C)
        self.delay = delay
        esn0 = 10.0 ** (traffic["esn0_db"] / 10.0)
        sigma = float(np.sqrt(sps / esn0 / 2.0))

        dev = torch.device(device)
        pool = torch.as_tensor(
            np.stack([np.concatenate(syms).real, np.concatenate(syms).imag]),
            dtype=torch.float32, device=dev)                    # (2, P)
        start = np.concatenate([[0], np.cumsum(lens)[:-1]])
        # symbol n of a channel: slot j(n), offset r(n) inside it
        slot_of = np.repeat(np.arange(R), slot_len)
        off_in = np.arange(slot_of.size) - np.repeat(
            np.concatenate([[0], np.cumsum(slot_len)[:-1]]), slot_len)
        idx = (torch.as_tensor(start[order], device=dev)[:, slot_of]
               + torch.as_tensor(off_in, device=dev)[None])     # (C, Ns)
        sym = pool[:, idx]                                      # (2, C, Ns)
        up = torch.zeros((2, C, N), dtype=torch.float32, device=dev)
        up[:, :, ::sps] = sym
        del sym, idx
        # circular RRC pulse shaping, real taps on both rails
        h = torch.as_tensor(np.asarray(taps, np.float32), device=dev)
        K = h.numel()
        x = torch.nn.functional.pad(up.reshape(2 * C, 1, N), (K - 1, 0),
                                    mode="circular")
        with _exact_fp32():
            wave = torch.nn.functional.conv1d(x, h.flip(0)[None, None])
        wave = wave.reshape(2, C, N)
        del x, up
        # per-channel integer delay (circular), carrier phase, noise
        n = torch.arange(N, device=dev)
        src = (n[None] - torch.as_tensor(delay, device=dev)[:, None]) % N
        wave = torch.gather(wave, 2, src[None].expand(2, C, N))
        del src
        c, s = (torch.as_tensor(f(phase), dtype=torch.float32,
                                device=dev)[:, None] for f in (np.cos, np.sin))
        re = wave[0] * c - wave[1] * s
        im = wave[0] * s + wave[1] * c
        del wave
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        noise = torch.randn((C, N, 2), generator=gen, device=dev)
        self.wave = torch.stack([re, im], dim=-1).add_(noise, alpha=sigma)

    def host_window(self, start, n):
        """Samples [start, start + n) of every channel (cyclic), as the
        (C, n) complex64 host array that ``prime`` takes."""
        N = self.n_samples
        idx = torch.arange(start, start + n, device=self.wave.device) % N
        w = self.wave[:, idx].cpu().numpy()
        return (w[..., 0] + 1j * w[..., 1]).astype(np.complex64)


class _exact_fp32:
    """float32 convolutions without TF32, restored on exit."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.saved
