"""Time-axis sharding with an overlap-save halo.

Port of ``dvbs2rx_tpu/parallel/stream_shard.py``. Besides running
independent channels side by side (``batch.py``), one very-high-rate
stream can be cut along its sample-time axis over a mesh of devices.
Windowed front-end operations (the SOF/PLSC differential correlators, FIR
matched filters) then need the tail of the previous shard: the
overlap-save halo, the reference's block history (``gr::block::
set_history``). JAX moves it with one ``ppermute`` hop; here shard i takes
the last samples of shard i-1 with ``.to(devices[i], non_blocking=True)``,
and shard 0 takes zeros (stream start), the ppermute with a zeroed first
hop.

A time mesh is a ``parallel.mesh.Mesh`` with axis ``"t"``; a sharded array
is the list of its D chunks (``shard_time``), and the sharded functions
return one output chunk per device (``mesh.gather`` concatenates them).
Arrays are planar (re, im) float32 (``ops/cplx.py``).

The matched filter is ``torch.nn.functional.conv1d`` with one tap set,
TF32 off (``utils.runtime.exact_fp32``): the JAX function is
``lax.conv_general_dilated``, outside any Pallas kernel, not the segmented
matched-filter kernel.
"""

import torch

from ..ops import plsync
from ..utils.runtime import exact_fp32
from .mesh import Mesh, all_cards

HALO = 90  # PLHEADER length: history needed by the dense timing metric


def make_time_mesh(devices=None) -> Mesh:
    """A time mesh (axis ``"t"``) over ``devices``; ``None`` means every
    visible CUDA device and raises when there is none."""
    return Mesh(all_cards() if devices is None else devices, "t")


def shard_time(mesh: Mesh, arr):
    """Split a (T, ...) array along its leading (time) axis into one chunk
    per device of ``mesh``."""
    return mesh.split(arr, 0)


def _halos(mesh: Mesh, shards, n):
    """Shard i's halo: the last ``n`` rows of shard i-1 on device i; zeros
    for shard 0."""
    out = [torch.zeros((n,) + tuple(shards[0].shape[1:]),
                       dtype=shards[0].dtype, device=mesh.devices[0])]
    for i in range(1, mesh.size):
        out.append(shards[i - 1][-n:].to(mesh.devices[i], non_blocking=True))
    return out


def sharded_timing_metric(mesh: Mesh):
    """Dense SOF+PLSC timing metric over a time-sharded symbol stream.

    Returns ``f(symbols) -> [metric chunk (T/D,) per device]`` for symbols
    (T, 2) (or ``shard_time``'s list); device i takes the last 90 symbols
    of device i-1 as history and device 0 zeros, so the gathered result
    equals the unsharded ``ops.plsync.timing_metric`` with zero history.
    """
    def fn(symbols):
        shards = shard_time(mesh, symbols)
        out = []
        for dev, sym, halo in zip(mesh.devices, shards,
                                  _halos(mesh, shards, HALO)):
            with Mesh.on(dev):
                out.append(plsync.timing_metric(sym, halo)[0])
        return out

    return fn


def sharded_matched_filter(mesh: Mesh, taps, sps: int = 2):
    """Matched filter + decimation over a time-sharded stream.

    Returns ``f(samples) -> [symbol chunk (T/D/sps, 2) per device]`` for
    samples (T, 2) (or ``shard_time``'s list; each chunk a multiple of
    ``sps`` long). Device i takes the last ``len(taps) - 1`` samples of
    device i-1 as history and device 0 zeros, so the gathered result
    equals the unsharded ``y[k] = sum_j x[k*sps - (L-1) + j] * taps[j]``
    with zero history."""
    exact_fp32()
    taps = torch.as_tensor(taps, dtype=torch.float32)
    L = int(taps.shape[0])
    w = [taps.to(d)[None, None, :] for d in mesh.devices]

    def fn(samples):
        shards = shard_time(mesh, samples)
        out = []
        for i, (dev, x, halo) in enumerate(zip(mesh.devices, shards,
                                               _halos(mesh, shards, L - 1))):
            with Mesh.on(dev):
                ext = torch.cat([halo, x], dim=0)          # (T/D + L-1, 2)
                y = torch.nn.functional.conv1d(ext.t()[:, None, :], w[i],
                                               stride=sps)
                out.append(y[:, 0, :].t())                  # (T/D/sps, 2)
        return out

    return fn
