"""``StreamReceiver.make_scan_step``: the CCM stream receiver's scan, one
CUDA-graph replay of ``scan_steps`` chained steps a call, fed the ring's
next ``scan_steps`` blocks (the ring holds a number of blocks prime to
``scan_steps``, so no two consecutive calls see the same blocks).

The driver builds the receiver through its public constructor, acquires
as the product does (``StreamSession``: a soft ``prime`` on the samples
just before the ring's first block, then eager steps that re-acquire the
channels that did not lock, up to the traffic's ``lock_steps``), and
hands that state to the scan; a channel still unlocked then decodes
wrong frames and the check says so.

Numbers this surface adds to the frame comparison (``LIMITS``):

- ``hdr_crc_failed``: window frames whose BBHEADER CRC-8 the receiver
  flags as failed;
- ``crc_map_diff``: sampled frames whose CRC-8 map differs from the
  reference's over the delivered bytes (``CRC_FRAMES`` of them);
- ``fe_sym_gap``: over ``check_calls`` seed-drawn window calls, the
  widest gap between the front end's last symbols of the call (the
  state's ``sym_tail``, the matched filter's output) and the plain front
  end's (``reference.frontend``) followed through the call's steps from
  the state the call started with, as a share of the channel's RMS
  symbol;
- ``fe_tau_gap``: the same calls' widest gap of the timing tracker's
  position (``ff_tau``, in samples) after the call.
"""

import numpy as np
import torch

from ..reference import check as ref
from ..reference import frontend

# fe_sym_gap, fe_tau_gap: set between sound runs (at most 3.4e-6, 4.6e-7
# on 13 seeds at Es/N0 6 dB; 2.8e-6, 4.4e-7 on 12 at 10 dB) and the TF32
# control (at least 1.0e-3, 3.3e-5 on 3 seeds at 6 dB; 9.1e-4, 2.0e-5 on
# 3 at 10 dB), NVIDIA H100 80GB HBM3 (PERF.md section 2)
LIMITS = {"hdr_crc_failed": 0, "crc_map_diff": 0,
          "fe_sym_gap": 1.0e-4, "fe_tau_gap": 5.0e-6}
CRC_FRAMES = 256
STATE_IN = frontend.STATE + ("rot_inc", "cum_foffset")
STATE_OUT = ("sym_tail", "ff_tau")


def rx_config(config, overrides=None):
    """The configuration's ``RxConfig``, with ``overrides`` (a dict of its
    fields, e.g. a fault's) applied."""
    from dvbs2rx_tpu_torch.rx.receiver import RxConfig

    fields = dict(config["rx"], **(overrides or {}))
    return RxConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in fields.items()})


class Driver:
    """Call i replays the graph over blocks iT, ..., iT + T - 1 (cyclic)."""

    def __init__(self, config, traffic, stim, device, rx_overrides=None):
        from dvbs2rx_tpu_torch.rx.stream import StreamReceiver, StreamSession

        cfg = rx_config(config, rx_overrides)
        C, F, T = config["channels"], config["frames_per_step"], \
            config["scan_steps"]
        self.config = config
        self.sr = sr = StreamReceiver(cfg, n_channels=C, frames_per_step=F,
                                      device=device)
        n_in = sr.n_in
        S, rem = divmod(stim.n_samples, n_in)
        if rem or np.gcd(S, T) != 1:
            raise ValueError(f"the ring holds {stim.n_samples} samples a "
                             f"channel: not a number of {n_in}-sample "
                             f"blocks prime to {T}")
        self.C, self.F, self.T, self.n_in, self.S = C, F, T, n_in, S
        self.n_fe = n_in + sr.sync.history()
        # (S + T - 1, C, n_in, 2): the S blocks, then the first T - 1 again
        ext = torch.cat([stim.wave, stim.wave[:, : (T - 1) * n_in]], dim=1)
        self.ring = ext.view(C, S + T - 1, n_in, 2).transpose(0, 1) \
            .contiguous()
        del ext
        session = StreamSession(sr)
        session.prime(stim.host_window(stim.n_samples - self.n_fe,
                                       self.n_fe))
        self.block = 0
        while self.block < traffic["lock_steps"]:
            session.step(self.ring[self.block % S])
            self.block += 1
            if self.block >= 2 and not session.need.any():
                break
        self.state = session.state
        self.first_block = {}           # call index -> its first block
        self.snaps = []                 # the checked calls' states
        self.scan = sr.make_scan_step(T)
        self.samples_per_call = T * C * n_in
        self.steps_per_call = T
        self.n_buf = sr.N_BUF
        self.history = self.n_fe - n_in

    def geometry(self):
        sr = self.sr
        return {"channels": self.C, "frames_per_step": self.F,
                "n_in": self.n_in, "n_out": sr.n_out,
                "history": self.history,
                "frame_len": sr.frame_len, "payload_len": sr.payload_len,
                "n_ldpc": sr.cfg.fec.nldpc, "n_mod": sr.cfg.pls_info.n_mod,
                "xfec_len": sr.cfg.pls_info.xfecframe_len,
                "header_syms": 90}

    def call(self, index, snap=False):
        off = self.block % self.S
        self.first_block[index] = self.block
        self.block += self.T
        if snap:
            before = {k: self.state[k].clone() for k in STATE_IN}
        self.state, kb, stats = self.scan(self.state,
                                          self.ring[off: off + self.T])
        if snap:
            self.snaps.append({
                "off": off, "in": before,
                "out": {k: self.state[k].clone() for k in STATE_OUT},
                "cum": stats["cum_foffset"].clone()})
        leaves = [("kbytes", kb, None)]
        leaves += [("stats." + k, v, None) for k, v in stats.items()]
        return leaves

    def records(self, index, host):
        """One call's frames: channel, place in the channel's stream, kind,
        the delivered row, and the receiver's CRC maps beside it."""
        kb = host["kbytes"]                          # (T, C, F, nb)
        T, C, F, nb = kb.shape
        t, c, f = np.meshgrid(np.arange(T), np.arange(C), np.arange(F),
                              indexing="ij")
        place = (self.first_block[index] + t) * F + f
        return {"chan": c.reshape(-1), "place": place.reshape(-1),
                "kind": np.zeros(T * C * F, np.int64),
                "rows": kb.reshape(-1, nb),
                "ts_ok": host["stats.ts_ok"].reshape(T * C * F, -1),
                "hdr_ok": host["stats.hdr_ok"].reshape(-1)}

    @staticmethod
    def flagged(rec):
        """Frames the receiver itself flags as failed, by number."""
        return {"hdr_crc_failed": rec["hdr_ok"] == 0}

    def close(self):
        """Free the program's receiver and state; the ring and the checked
        calls' states stay for ``numbers``."""
        del self.scan, self.state, self.sr

    def numbers(self, kept, rng, control=False):
        """This surface's sampled numbers, after the window (the program
        freed). ``control``: the plain front end in TF32 takes the
        program's place."""
        out = {}
        if kept is not None and kept["chan"].size:
            pick = rng.permutation(kept["chan"].size)[:CRC_FRAMES]
            ok, hdr = ref.crc8_map(ref.descramble(kept["rows"][pick]))
            diff = (ok != kept["ts_ok"][pick]).any(axis=1) | \
                (hdr != kept["hdr_ok"][pick])
            out["crc_map_diff"] = int(diff.sum())
        if self.snaps:
            sym, tau = zip(*(self._frontend_gaps(s, control)
                             for s in self.snaps))
            out["fe_sym_gap"] = max(sym)
            out["fe_tau_gap"] = max(tau)
        return out

    def _frontend_gaps(self, snap, control):
        """The front end's gaps over one checked call (``reference.
        frontend.gaps``). The rotator increment of each step: the call's,
        then the one the closed loop formed from the step before's
        cumulative offset."""
        st0 = snap["in"]
        cum = torch.cat([st0["cum_foffset"][None], snap["cum"][:-1]])
        incs = -cum * (2 * np.pi) / self.config["rx"]["sps"]
        incs[0] = st0["rot_inc"]
        blocks = self.ring[snap["off"]: snap["off"] + self.T]
        return frontend.gaps(self.config["rx"], self.n_in, self.n_buf, st0,
                             blocks, incs, snap["out"], control)
