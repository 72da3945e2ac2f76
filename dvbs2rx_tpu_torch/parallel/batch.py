"""Per-lane PLFRAME processing over a (channel x frame) lane batch.

Port of ``make_lane_fn`` and ``BatchedPipeline`` from
``dvbs2rx_tpu/parallel/batch.py``. The JAX closure processes one frame and
is vmapped over lanes; here the lane axis is written out. At the boundary
it stays trailing, as the JAX vmap's ``in_axes=-1`` / ``out_axes`` put it:
headers (91, 2, C, F+1), payloads (Lp, 2, C, F), int8 LLRs out (N, B).
The lane function reads them in place through strided views (the
PLHEADER and payload kernels of ``ops.plsync_cuda``).

``make_channel_mesh`` and ``shard_channels`` are the JAX module's mesh
helpers over ``parallel.mesh.Mesh``: a channel mesh is a list of devices
with the axis ``"ch"``, and a sharded array is a list of per-device
chunks. ``BatchedPipeline(mesh=)`` runs one pipeline of C/D channels per
device.
"""

import numpy as np
import torch

from ..ops import cplx, plsync_cuda
from ..rx.receiver import FECStage, RxConfig
from ..spec.pl_defs import PLHEADER_LEN
from ..utils.runtime import device_table
from .mesh import Mesh, all_cards


# how the shards' whole-step statistics combine under a mesh
PIPELINE_REDUCE = {"bch_errors": "sum", "metric_min": "min",
                   "ldpc_iters": "max"}


def make_channel_mesh(devices=None) -> Mesh:
    """A channel mesh (axis ``"ch"``) over ``devices``; ``None`` means every
    visible CUDA device and raises when there is none. Devices may repeat
    (``["cpu"] * D``, or one card D times)."""
    return Mesh(all_cards() if devices is None else devices, "ch")


def shard_channels(mesh: Mesh, arr, axis: int = -2):
    """Split an array along its channel axis (default: second-to-last, the
    lane-major convention) into one chunk per device of ``mesh``, each on
    its device. A list is taken as already split."""
    if isinstance(arr, (list, tuple)):
        return mesh.split(arr)
    return mesh.split(arr, axis % arr.ndim)


def make_lane_fn(cfg, descr):
    """Lane-batched PLFRAME processing closure.

    ``lane(own, nxt, sym, start, coarse_corrected, n0_override,
    x_every=0)``: own/nxt (X, Y, 90, 2) views of each lane's PLHEADER and
    of the next frame's (lane b = x Y + y, B = X Y), sharing their
    strides; sym (X, Y, rows, 2) each lane's symbol buffer, whose payload
    starts at row ``start[b]`` ((B,) int64, clamped into [0, rows - Lp];
    None: row 0), read in place; coarse_corrected (B,) bool, n0_override
    (B,) float (> 0 demaps with the post-decoder refined N0). ``descr`` is
    the (Lp, 2) planar PL descrambling sequence on the lanes' device.
    Returns a dict with metric (B, 2), autocorr (B, 89, 2), fine (B,), n0
    (B,), llrs (N, B) int8 (lane-major, the FEC stage's layout) and, with
    ``x_every`` > 0, x0 (B / x_every, R, 2) the corrected symbols of lanes
    0, x_every, ... (frame 0 of each channel). Three launches on the card
    (``ops.plsync_cuda``: the PLHEADER kernel, then the payload's
    statistics and demap kernels); their plain versions on the CPU.
    """
    info = cfg.pls_info
    pls_tab = np.array([cfg.pls], np.int64)
    R = info.n_slots * 90
    N = R * info.n_mod

    def lane(own, nxt, sym, start, coarse_corrected, n0_override,
             x_every=0):
        dev = own.device
        B = own.shape[0] * own.shape[1]
        pls = device_table(pls_tab, dev)
        hk = plsync_cuda.plheader([own, nxt], [pls, pls],
                                  n_auto=PLHEADER_LEN, metric=True)
        llrs = torch.empty((N, B), dtype=torch.int8, device=dev)
        fine = torch.empty((B,), dtype=torch.float32, device=dev)
        n0 = torch.empty((B,), dtype=torch.float32, device=dev)
        x0 = (torch.empty((B // x_every, R, 2), dtype=torch.float32,
                          device=dev) if x_every else None)
        plsync_cuda.payload(sym, start, info.payload_len, descr, hk["phase"],
                            coarse_corrected, n0_override, info,
                            cfg.constellation, cfg.rate, llrs, fine, n0,
                            x_out=x0, x_every=max(x_every, 1))
        return {"metric": hk["metric"], "autocorr": hk["autocorr"],
                "fine": fine, "n0": n0, "llrs": llrs, "x0": x0}

    return lane


class BatchedPipeline:
    """Steady-state locked pipeline over a (channel x frame) lane batch.

    One ``step`` call takes frame-aligned symbol groups for each channel and
    produces decoded BBFRAME bytes plus aggregated statistics: the lane
    function over all C x F lanes (int8 LLRs), then the lane-major
    FEC stage (one LDPC launch of B = C x F frames on the card).
    Acquisition and TS stitching stay on the host. On the card unless
    ``device="cpu"``.

    With ``mesh`` (a channel mesh, C divisible by D) the pipeline holds one
    local pipeline of C/D channels per device; ``step`` splits its inputs
    along channels (or takes ``shard_channels``' lists), runs each shard on
    its device with the BCH form that reads nothing back, and returns
    outputs equal to the unsharded pipeline's: kbytes and n0 concatenated
    along channels on the first device, ``bch_errors`` summed,
    ``metric_min`` the minimum and ``ldpc_iters`` the maximum over the
    shards, as XLA reduces them under the JAX mesh.
    """

    def __init__(self, cfg: RxConfig, n_channels: int, frames_per_step: int,
                 device=None, mesh: Mesh = None):
        self.cfg = cfg
        self.n_channels = n_channels
        self.frames_per_step = frames_per_step
        self.mesh = mesh
        self._shards = None
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both")
            D = mesh.shape["ch"]
            if n_channels % D:
                raise ValueError(f"n_channels={n_channels} not divisible by "
                                 f"mesh size {D}")
            device = mesh.devices[0]
            self._shards = [
                BatchedPipeline(cfg, n_channels // D, frames_per_step,
                                device=d) for d in mesh.devices]
        self.fec = FECStage(cfg, device)
        self.device = self.fec.device
        self.frame_len = self.fec.frame_len
        self.payload_len = self.fec.payload_len
        self._lane = make_lane_fn(cfg, self.fec.descr)

    def step(self, headers_ext, payloads, coarse_corrected):
        """headers_ext (91, 2, C, F+1), payloads (payload_len, 2, C, F)
        float32 (tensors on the pipeline's device, or numpy arrays),
        coarse_corrected a bool for every lane. Lane b = c*F + f (minor
        axis); frame b's next header is entry f+1 of its channel's header
        window.

        Returns (kbytes (C, F, kbch/8) uint8 BB-scrambled, n0 (C*F,) float32,
        stats {"bch_errors", "metric_min", "ldpc_iters"} 0-dim tensors)."""
        if self.mesh is None:
            return self._step(headers_ext, payloads, coarse_corrected, False)
        mesh = self.mesh
        outs = []
        for loc, h, p in zip(self._shards, shard_channels(mesh, headers_ext),
                             shard_channels(mesh, payloads)):
            with Mesh.on(loc.device):
                outs.append(loc._step(h, p, coarse_corrected, True))
        return (mesh.gather([o[0] for o in outs]),
                mesh.gather([o[1] for o in outs]),
                mesh.merge([o[2] for o in outs], PIPELINE_REDUCE))

    def _step(self, headers_ext, payloads, coarse_corrected, sync_free):
        C, F = self.n_channels, self.frames_per_step
        B = C * F
        dev = self.device
        headers_ext = torch.as_tensor(headers_ext, device=dev)
        payloads = torch.as_tensor(payloads, device=dev)
        # (C, F, n, 2) views of the lane-major inputs: lane b = c F + f
        hdr = headers_ext[1:].permute(2, 3, 0, 1)
        sym = payloads.permute(2, 3, 0, 1)
        if isinstance(coarse_corrected, torch.Tensor):
            cc = coarse_corrected.to(dev, torch.bool).expand(B)
        else:       # a fill, not a host->device copy (which would sync)
            cc = torch.full((B,), bool(coarse_corrected), device=dev)
        n0_ov = torch.full((B,), -1.0, device=dev)
        out = self._lane(hdr[:, :F], hdr[:, 1:], sym, None, cc, n0_ov)
        kbytes, n_corr, iters, _ok, _hard = self.fec.lane_major(out["llrs"],
                                                                sync_free)
        stats = {
            "bch_errors": (n_corr < 0).sum(),
            "metric_min": out["metric"].min(),
            "ldpc_iters": iters.max(),
        }
        return kbytes.reshape(C, F, -1), out["n0"], stats

    def frame_inputs_from_symbols(self, symbols):
        """Host helper: frame-aligned symbol stream (C, n_syms) complex ->
        lane-major numpy (headers_ext (91, 2, C, F+1), payloads
        (payload_len, 2, C, F)) float32.

        Assumes symbol index 0 is a SOF start (steady-state locked). The
        lane-axis-minor layout is built on the host so the device step never
        pays a relayout.
        """
        h, p = self.channel_major_inputs(symbols)
        headers_ext = np.ascontiguousarray(h.transpose(2, 3, 0, 1))
        payloads = np.ascontiguousarray(p.transpose(2, 3, 0, 1))
        return headers_ext, payloads

    def channel_major_inputs(self, symbols):
        """(C, n_syms) -> channel-major numpy (C, F+1, 91, 2), (C, F, Lp, 2)
        float32. Header indices are clipped into the stream (the first
        header's extension symbol, index -1, reads symbol 0)."""
        F = self.frames_per_step
        L = self.frame_len
        need = (F + 1) * L + 91
        assert symbols.shape[1] >= need - L, "not enough symbols"
        idx_h = np.arange(F + 1)[:, None] * L + np.arange(-1, 90)[None, :]
        idx_h = np.clip(idx_h, 0, symbols.shape[1] - 1)
        headers_ext = cplx.from_np(symbols[:, idx_h])
        idx_p = (90 + np.arange(F)[:, None] * L
                 + np.arange(self.payload_len)[None, :])
        payloads = cplx.from_np(symbols[:, idx_p])
        return headers_ext, payloads
