"""Carrying receiver state and constant tables across to the port.

The receiver has no weights: its parameters are constant tables, all built
from the port's own ``spec`` numpy. Its carried state is the JAX
``StreamReceiver`` state pytree (``init_state_np()`` / ``prime()``,
``dvbs2rx_tpu/rx/stream.py:120-142``), a flat dict of arrays with a
leading channel axis.

- ``state_from_numpy`` / ``state_to_numpy`` map that dict to the port's
  state tensors and back, dtype for dtype (bool stays bool), so a test can
  prime the JAX receiver and step both receivers from the same state.
- ``vcm_state_from_numpy`` / ``vcm_state_to_numpy`` do the same for the
  ``VCMStreamReceiver`` state (``dvbs2rx_tpu/rx/vcm_stream.py:256-294``),
  whose symbol ring and FEC queues the port keeps transposed: the ring
  planar (C, N_SYM, 2) where JAX has it rail-major (C, 2, N_SYM), the LLR
  and symbol-snapshot queues one frame per row (S, CAP, N) where JAX has
  them lane-major (S, N, CAP).
- ``ffsync_state_from_numpy`` / ``ffsync_state_to_numpy`` and
  ``refined_n0_from_numpy`` carry what the host receivers
  (``rx/receiver.py`` ``Receiver``, ``ACMReceiver``) keep beside their
  numpy buffers: the feed-forward timing state of their one channel (the
  JAX ``FFSyncState`` of scalars; the port's of (1,) tensors) and the
  post-decoder refined N0 (per PLS in the ACM receiver; the JAX CCM
  receiver's ``None`` is the port's 0.0, "not refined yet").
- ``symbol_sync_state_from_numpy`` / ``symbol_sync_state_to_numpy`` carry
  the Gardner loop state (the JAX ``SymbolSyncState`` leaves as numpy, one
  channel's scalars or with a leading channel axis) to the port's
  ``SymbolSyncState`` of (C,) tensors and back, with the channel axis.
- ``tables_from_spec`` gathers the constant tables of one configuration
  as device tensors, from the same builders the port's modules use.
"""

import numpy as np
import torch

from .spec import bch_spec
from .spec.ldpc_tables import get_code
from .spec.rrc import polyphase_rrc_bank
from .spec.scramblers import (
    bb_derandomizer_bytes,
    pl_descrambling_sequence,
)


def state_from_numpy(state_np: dict, device) -> dict:
    """Host state dict (JAX pytree leaves as numpy) -> device tensors."""
    out = {}
    for k, v in state_np.items():
        a = np.ascontiguousarray(np.asarray(v))
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def state_to_numpy(state: dict) -> dict:
    """Inverse of ``state_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


# VCM state leaves whose port layout swaps the JAX layout's last two axes
VCM_TRANSPOSED = ("symbuf", "qllr", "qxf")


def vcm_state_from_numpy(state_np: dict, device) -> dict:
    """JAX-layout VCM state dict (numpy leaves) -> the port's tensors."""
    return state_from_numpy(
        {k: np.swapaxes(np.asarray(v), -1, -2) if k in VCM_TRANSPOSED
         else v for k, v in state_np.items()}, device)


def vcm_state_to_numpy(state: dict) -> dict:
    """Inverse of ``vcm_state_from_numpy``: the JAX layout, as numpy."""
    out = state_to_numpy(state)
    return {k: np.ascontiguousarray(np.swapaxes(v, -1, -2))
            if k in VCM_TRANSPOSED else v for k, v in out.items()}


def ffsync_state_from_numpy(state_np: dict, device):
    """One channel's timing state, ``{"tau", "rate", "initialized"}`` as
    numpy scalars (the JAX ``FFSyncState`` leaves) -> the port's
    ``FFSyncState`` with (1,) leaves on ``device``."""
    from .ops.ffsync import FFSyncState

    def leaf(k, dtype):
        return torch.tensor(np.asarray(state_np[k], dtype).reshape(1),
                            device=device)

    return FFSyncState(tau=leaf("tau", np.float32),
                       rate=leaf("rate", np.float32),
                       initialized=leaf("initialized", np.int32))


def ffsync_state_to_numpy(state) -> dict:
    """Inverse of ``ffsync_state_from_numpy``: numpy scalars."""
    return {k: getattr(state, k).detach().cpu().numpy().reshape(())
            for k in ("tau", "rate", "initialized")}


# the Gardner state's leaves: dtype and per-channel shape
_SYMBOL_SYNC_LEAVES = {"cnt": (np.float32, ()), "mu": (np.float32, ()),
                       "vi": (np.float32, ()), "jump": (np.int32, ()),
                       "last_xi": (np.float32, (2,)), "n": (np.int32, ())}


def symbol_sync_state_from_numpy(state_np: dict, device):
    """Gardner loop state, ``{"cnt", "mu", "vi", "jump", "last_xi", "n"}``
    as numpy (the JAX ``SymbolSyncState`` leaves of one channel, or the
    same with a leading channel axis) -> the port's ``SymbolSyncState``
    with (C,) leaves (``last_xi`` (C, 2)) on ``device``."""
    from .ops.frontend import SymbolSyncState

    out = {}
    for k, (dtype, tail) in _SYMBOL_SYNC_LEAVES.items():
        a = np.asarray(state_np[k], dtype).reshape((-1,) + tail)
        out[k] = torch.from_numpy(a.copy()).to(device)
    return SymbolSyncState(**out)


def symbol_sync_state_to_numpy(state) -> dict:
    """Inverse of ``symbol_sync_state_from_numpy``: numpy leaves with the
    leading channel axis."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in _SYMBOL_SYNC_LEAVES}


def refined_n0_from_numpy(n0) -> dict:
    """Refined N0 per PLS, ``{pls: value}`` with None for "not refined
    yet" -> ``{pls: float}`` with 0.0 for it, the port's convention."""
    return {int(p): 0.0 if v is None else float(v) for p, v in n0.items()}


def tables_from_spec(cfg, device) -> dict:
    """The constant tables of configuration ``cfg`` as tensors on
    ``device``: LDPC edge tables (kernel layout), BCH syndrome matrix and
    GF(2^m) tables, RRC polyphase bank and half-band taps, frame-sync
    correlator kernels, PL descrambling sequence and BB scrambler bytes."""
    from .ops import cplx, plsync
    from .ops.ffsync import halfband_taps
    from .ops.ldpc_cuda import kernel_tables

    fec = cfg.fec
    info = cfg.pls_info
    ptr, base, shift, sync = kernel_tables(get_code(fec.ldpc_table))
    field = bch_spec.field_for(fec.framesize)
    bank, _, _ = polyphase_rrc_bank(cfg.sps, cfg.rolloff, cfg.rrc_delay,
                                    cfg.n_subfilt)
    k_sof, k_plsc = plsync.frame_sync_kernels()
    tables = {
        "ldpc_layer_ptr": ptr,
        "ldpc_edge_base": base,
        "ldpc_edge_shift": shift,
        "ldpc_edge_sync": sync,
        "bch_A": bch_spec.syndrome_bit_matrix(fec.framesize, fec.t,
                                              fec.nbch).astype(np.float32),
        "bch_exp": field.exp.astype(np.int64),
        "bch_log": field.log.astype(np.int64),
        "rrc_bank": bank,
        "halfband": halfband_taps(),
        "sof_kernel": cplx.from_np(k_sof),
        "plsc_kernel": cplx.from_np(k_plsc),
        "pl_descramble": cplx.from_np(
            pl_descrambling_sequence(cfg.gold_code)[: info.payload_len]),
        "bb_scramble": bb_derandomizer_bytes(fec.kbch // 8),
    }
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in tables.items()}
