"""The port's device mesh: an ordered list of devices and one axis name.

The JAX package shards with ``jax.sharding.Mesh`` and ``shard_map``: one
host program drives every device (single-controller). The port keeps that
model. A ``Mesh`` is a list of ``torch.device``s in one process, and a
sharded value is a list with one tensor (or state dict) per device. A
process group (``torch.distributed``) would add a launcher and a
multi-process contract that the JAX package does not have.

``mesh.shape[axis]`` is the number of shards D, as JAX spells it. Devices
may repeat: ``["cpu"] * 8`` stands for the JAX tests' 8 virtual CPU
devices, and ``[cuda:0] * D`` runs every shard on one card.

Each shard's work is queued under its device (``on``), so on distinct
cards the shards run side by side as long as nothing reads back to the
host between them.
"""

import contextlib

import numpy as np
import torch

from ..utils.runtime import resolve_device


class Mesh:
    """Devices along one named axis (``"ch"`` or ``"t"``)."""

    def __init__(self, devices, axis: str):
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = (axis,)
        self.shape = {axis: len(devices)}
        self.size = len(devices)

    def __repr__(self):
        devs = [str(d) for d in self.devices]
        return f"Mesh({devs}, {self.axis_names[0]!r})"

    @staticmethod
    def on(device):
        """Context in which ``device``'s work is queued: its CUDA device
        (so ``torch.cuda.current_stream()`` and the kernels' launches go to
        that card), nothing for the CPU."""
        if device.type == "cuda":
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    def split(self, x, dim: int = 0):
        """One chunk of ``x`` per device along ``dim`` (a numpy array or a
        tensor; its size there must divide by D), each on its device. A
        list is taken as already split and returned as it is."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.size:
                raise ValueError(f"{len(x)} shards for a mesh of {self.size}")
            return list(x)
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"axis of {n} does not divide by the mesh "
                             f"size {self.size}")
        k = n // self.size
        if isinstance(x, np.ndarray):
            parts = np.split(x, self.size, axis=dim)
            return [torch.as_tensor(np.ascontiguousarray(p), device=d)
                    for p, d in zip(parts, self.devices)]
        return [x.narrow(dim, i * k, k).to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]

    def gather(self, parts, dim: int = 0):
        """The shards concatenated along ``dim`` on the first device."""
        d0 = self.devices[0]
        return torch.cat([p.to(d0, non_blocking=True) for p in parts], dim)

    def merge(self, parts, reduce, dim: int = 0):
        """Per-shard dicts of tensors as one dict on the first device: the
        leaves ``reduce`` names combined over the shards (``"sum"``,
        ``"min"`` or ``"max"``, as XLA reduces a whole-array statistic
        under the JAX mesh; in the leaf's dtype), every other leaf
        concatenated along ``dim``."""
        d0 = self.devices[0]
        out = {}
        for k in parts[0]:
            vals = [p[k] for p in parts]
            how = reduce.get(k)
            if how is None:
                out[k] = self.gather(vals, dim)
            else:
                v = torch.stack([x.to(d0, non_blocking=True) for x in vals])
                out[k] = getattr(v, _REDUCE[how])(0).to(v.dtype)
        return out


_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def all_cards():
    """Every visible CUDA device; raises without one (a mesh never falls
    back to the CPU on its own)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device: pass devices=['cpu'] * D for a "
                           "mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
