"""The device-resident VCM stream receiver over a channel mesh.

Port of ``dvbs2rx_tpu/parallel/vcm_shard.py``; the design is the JAX
module's. C channels split evenly over the D devices of a ``("ch",)``
mesh (``parallel.batch.make_channel_mesh``). Everything in the VCM step is
channel-parallel except the pooled per-PLS FEC queues, which the
single-device receiver fills from every channel. Pooling across devices
would drag every frame through a cross-device copy in the hot loop, so
each shard pools its own channels: one local ``VCMStreamReceiver`` of C/D
channels per device, with its own queues, draining its own
``B_fec``-frame batches. No traffic between shards touches the FEC path.
Per-lane convergence freezing (``ops/ldpc.py``) makes each frame's decode
independent of its batch, so every frame decodes to the unsharded
receiver's bytes; only the drain cadence (the step a frame comes out in)
and the refined-N0 batch statistics differ.

State: one local state dict per device (``prime`` and ``shard_state``
build it). ``prime`` runs the acquisition once through one full-width
receiver on the first device and splits its state, as the JAX module does.

Differences from ``VCMStreamReceiver.step``: outputs concatenate the
shards' drains (``DRAIN = D * DRAIN_local`` slots per PLS, on the first
device; ``meta`` carries global channel ids), and the whole-step scalar
statistics (``frames``, ``dummies``, ``rejected``, and ``ldpc_iters`` per
PLS) come back as per-shard (D,) vectors: sum them on the host.

Every shard's step A is queued before any shard's step B, whose queue-fill
readback is the step's one wait on each card, and the local receivers
take the BCH form that reads nothing back.
"""

import numpy as np
import torch

from ..convert import vcm_state_from_numpy
from ..rx.vcm_stream import VCMStreamReceiver
from .mesh import Mesh

_QKEYS = ("qllr", "qmeta", "qxf", "qfill")
# step A's whole-step scalars, returned per shard
_SCALARS = ("frames", "dummies", "rejected")


class ShardedVCMStreamReceiver:
    """``VCMStreamReceiver`` over a channel mesh (see the module
    docstring)."""

    def __init__(self, cfg, n_channels: int, mesh: Mesh,
                 frames_per_step: int = 2, fec_lanes: int = None,
                 allow_dummy: bool = True):
        D = mesh.shape["ch"]
        if n_channels % D:
            raise ValueError(
                f"n_channels={n_channels} not divisible by mesh size {D}")
        self.cfg = cfg
        self.mesh = mesh
        self.D = D
        self.n_channels = n_channels
        self._ctor = (cfg, frames_per_step, fec_lanes, allow_dummy)
        self.shards = [
            VCMStreamReceiver(cfg, n_channels // D, frames_per_step,
                              fec_lanes, device=d, allow_dummy=allow_dummy)
            for d in mesh.devices]
        for loc in self.shards:
            loc._bch_sync_free = True
        loc = self.local = self.shards[0]
        self.S, self.B_fec, self.pls_set = loc.S, loc.B_fec, loc.pls_set
        self.DRAIN = D * loc.DRAIN
        self.n_in, self._n_fe = loc.n_in, loc._n_fe
        self._full = None                     # the prime-only receiver

    # ---------------- state ----------------

    def init_state_np(self):
        """Zero state as a host dict in the JAX module's global layout:
        channel-led leaves at full C, queue leaves with a leading (D,)
        shard axis."""
        g = {}
        for k, v in self.local.init_state_np().items():
            if k in _QKEYS:
                g[k] = np.zeros((self.D,) + v.shape, v.dtype)
            else:
                g[k] = np.zeros((self.n_channels,) + v.shape[1:], v.dtype)
        return g

    def shard_state(self, state_np):
        """A global host state (``init_state_np``'s layout) -> one local
        state dict per device."""
        C_loc = self.n_channels // self.D
        return [vcm_state_from_numpy(
            {k: (v[i] if k in _QKEYS else v[i * C_loc:(i + 1) * C_loc])
             for k, v in state_np.items()}, dev)
            for i, dev in enumerate(self.mesh.devices)]

    def prime(self, iq_prefix: np.ndarray, strict: bool = True):
        """One-time acquisition through the unsharded receiver at full C,
        then the state split over the mesh (queues empty)."""
        if self._full is None:
            cfg, F, lanes, dummy = self._ctor
            self._full = VCMStreamReceiver(
                cfg, self.n_channels, frames_per_step=F, fec_lanes=lanes,
                device=self.mesh.devices[0], allow_dummy=dummy)
        st = self._full.prime(iq_prefix, strict=strict)
        self.prime_ok = self._full.prime_ok
        C_loc = self.n_channels // self.D
        empty = {k: v for k, v in self.local.init_state_np().items()
                 if k in _QKEYS}
        out = []
        for i, dev in enumerate(self.mesh.devices):
            local = vcm_state_from_numpy(empty, dev)
            for k, v in st.items():
                if k not in _QKEYS:
                    local[k] = v[i * C_loc:(i + 1) * C_loc].to(dev)
            out.append(local)
        return out

    # ---------------- the step ----------------

    def step(self, state, iq):
        """Sharded step: (list of shard states, iq (C, n_in, 2) host or
        device block, or a list per shard) -> (states', outputs, stats),
        with the layout differences of the module docstring."""
        mesh, C_loc = self.mesh, self.n_channels // self.D
        parts = []
        for loc, st, x in zip(self.shards, state, mesh.split(iq, 0)):
            with Mesh.on(loc.device):
                parts.append(loc._step_a(st, x))
        states, outs, stats_b = [], [], []
        for loc, (st, llr, xf, meta, sels, _) in zip(self.shards, parts):
            with Mesh.on(loc.device):
                st, o, sb = loc._step_b(st, llr, xf, meta, sels)
            states.append(st)
            outs.append(o)
            stats_b.append(sb)
        outputs = {k: [] for k in ("kb", "meta", "n_corr", "fired")}
        for si in range(self.S):
            for k in ("kb", "n_corr"):
                outputs[k].append(mesh.gather([o[k][si] for o in outs]))
            meta = [o["meta"][si].clone() for o in outs]
            for i, m in enumerate(meta):
                m[..., 0] += i * C_loc
            outputs["meta"].append(mesh.gather(meta))
            outputs["fired"].append(
                np.concatenate([o["fired"][si] for o in outs]))
        stats_a = [p[5] for p in parts]
        stats = {}
        for k in stats_a[0]:
            vals = [s[k] for s in stats_a]
            stats[k] = (torch.stack([v.to(mesh.devices[0]) for v in vals])
                        if k in _SCALARS else mesh.gather(vals))
        stats["ldpc_iters"] = [
            torch.stack([sb["ldpc_iters"][si].to(mesh.devices[0])
                         for sb in stats_b]) for si in range(self.S)]
        stats["n0_refined"] = mesh.gather([sb["n0_refined"]
                                           for sb in stats_b])
        return states, outputs, stats
