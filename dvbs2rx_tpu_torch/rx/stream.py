"""Device-resident locked steady-state receiver: IQ -> BBFRAME bytes -> TS.

Port of ``dvbs2rx_tpu/rx/stream.py``: ``StreamReceiver`` (``init_state_np``,
``prime``, ``step``, ``reacquire``), ``StreamSession`` (host lock policy)
and ``StreamEngine`` (the ``Receiver``-compatible product surface with the
native whole-step TS stitch). One step is ``state, iq -> state', kbytes,
stats`` over every channel at once, composing:

- AGC, rotator and the append to the right-aligned sample buffer
  (``ops.frontend_cuda.frontend``: the kernels of ``csrc/frontend.cu`` on
  the card);
- feed-forward O&M timing with the segmented polyphase matched filter
  (``ops.ffsync``; on the card the tracker kernel ``csrc/ffsync.cu`` and
  the matched filter ``csrc/mf_segmented.cu``, both reading the sample
  buffer in place);
- frame-window extraction and the early/late frame DLL;
- per-lane PL sync, descrambling and demap (``parallel.batch.make_lane_fn``:
  the PLHEADER and payload kernels ``csrc/plsync.cu`` on the card, which
  read the payloads in place and write int8 LLRs);
- layered LDPC (``csrc/ldpc_layered.cu`` on the card), BCH, byte packing;
- device CRC-8 validity (``ops.crc8_dev.packet_validity``);
- the host TS stitch (``spec.bb_frame.BatchTSStitcher``).

JAX jits and donates the step; PyTorch runs it eagerly. The step is
functional: it returns a new state dict and never writes the tensors of
the state it was given. The per-channel dynamic slices of the JAX step
(``jax.lax.dynamic_slice``, which clamps its start into range) are one
gather each with the same clamp.

``make_scan_step(T)`` chains T steps per call, JAX's ``lax.scan`` in one
dispatch: on the card one CUDA graph of the T steps, replayed each call.

Under a channel mesh (``mesh=``, ``parallel.mesh.Mesh`` with axis ``"ch"``)
the receiver holds one local receiver of C/D channels per device, the state
is a list of D state dicts, and a step runs every shard's step on its own
device (the JAX ``shard_map`` of the step). Acquisition (``prime``) runs
once at full width on the first device and the state is then split, as
JAX places the primed pytree with ``put_state``.

Host synchronisation points of one step: the BCH all-clean test (one flag;
the captured scan and the shards use the BCH form that reads nothing back)
and, in ``StreamSession``/``StreamEngine``, the per-step ``locked``,
``underflow``/``overflow`` and statistics readbacks.
"""

import queue as _queue
import threading
import time

import numpy as np
import torch

from .._build import launch_counts
from ..convert import sharded_state_from_numpy, state_from_numpy
from ..ops import cplx, plsync
from ..ops.crc8_dev import packet_validity
from ..ops.ffsync import FeedForwardSync, FFSyncState
from ..ops.frontend_cuda import frontend
from ..parallel.batch import make_lane_fn
from ..parallel.mesh import Mesh
from ..spec.bb_frame import BatchTSStitcher
from ..spec.scramblers import bb_derandomizer_bytes
from ..utils import spans
from ..utils.runtime import device_table, resolve_device
from ..utils.spans import span
from .receiver import (
    FECStage,
    RxConfig,
    RxStats,
    _snr_refine_n0,
    acq_metric,
    get_stats,
)

TAIL = 182          # carried symbols: one extended header window + margin
FP_MIN, FP_MAX = 2, 90
FP0 = 46            # nominal frame-start index inside the carried tail
# how the shards' whole-step scalars combine under a mesh (as XLA reduces
# them over the sharded axis); every other statistic leads with channels
SHARD_REDUCE = {"bch_errors": "sum", "ldpc_iters": "max",
                "ldpc_frame_iters": "sum", "ldpc_converged": "sum"}
# the LDPC counters: a scan call sums them over its steps (one scalar a
# call) where it stacks every other statistic
CALL_SUMS = ("ldpc_frame_iters", "ldpc_converged")


# the per-channel dynamic slice (``ops.cplx.window_rows``)
_window = cplx.window_rows


def prime_agc(iq, cfg):
    """Priming's AGC on the device block (C, n, 2): the gain agc_ref /
    mean|x| applied (the update with alpha 1 from a gain of 1), or none
    with the AGC off, through the front end's kernels; their rotation at
    phase 0 and increment 0 leaves every sample as it is, as the JAX
    priming does not rotate. Returns (block, gain (C,))."""
    C = iq.shape[0]
    zero = torch.zeros((C,), dtype=torch.float32, device=iq.device)
    fe = frontend(iq, zero + 1.0, zero, zero,
                  "update" if cfg.agc else "off", 1.0, cfg.agc_ref)
    return fe["out"], fe["gain"]


class StreamFrontEnd:
    """The front end both stream receivers share: AGC, rotator and
    feed-forward timing over a right-aligned sample buffer. A subclass sets
    ``device``, ``cfg``, ``sync``, ``n_in``, ``n_out``, ``_n_fe`` and
    ``N_BUF``."""

    def put_iq(self, iq_block):
        """One (C, n, 2) float32 host block onto the device."""
        return torch.as_tensor(iq_block, device=self.device)

    def _frontend(self, state, iq):
        """Returns (state' with the sample buffer, gain, rotator phase and
        timing updated, symbols (C, n_out, 2), overflow, underflow).

        Right-aligned sample buffer: valid data ends at index N_BUF, the
        append is a static shift, consuming samples shrinks sfill. On the
        card: the AGC and rotate-and-append kernels, then the tracker and
        the matched filter reading the block in place at N_BUF - sfill."""
        cfg = self.cfg
        n_in, n_out, n_fe = self.n_in, self.n_out, self._n_fe
        fe = frontend(iq, state["agc_gain"], state["rot_phase"],
                      state["rot_inc"], "update" if cfg.agc else "off",
                      min(1.0, cfg.agc_rate * n_in), cfg.agc_ref,
                      sbuf=state["sbuf"], sfill=state["sfill"])
        ff = FFSyncState(tau=state["ff_tau"], rate=state["ff_rate"],
                         initialized=state["ff_init"])
        ff2, syms, consumed = self.sync.step_batched(
            ff, fe["out"], n_out, start=fe["start"], length=n_fe)
        sfill = fe["sfill"] - consumed
        underflow = sfill < (n_fe - n_in)
        new_state = dict(
            state, sbuf=fe["out"], sfill=sfill, agc_gain=fe["gain"],
            rot_phase=fe["phase"], ff_tau=ff2.tau, ff_rate=ff2.rate,
            ff_init=ff2.initialized,
        )
        return new_state, syms, fe["overflow"], underflow


class StreamReceiver(StreamFrontEnd):
    """Locked steady-state multi-channel receiver as one device step.

    On the card unless ``device="cpu"``; with ``mesh`` (a channel mesh,
    ``parallel.batch.make_channel_mesh``) sharded over its devices instead,
    C divisible by D."""

    def __init__(self, cfg: RxConfig, n_channels: int,
                 frames_per_step: int = 2, device=None, mesh: Mesh = None):
        if cfg.sym_sync_impl != "ffw":
            raise ValueError("StreamReceiver requires sym_sync_impl='ffw'")
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
                StreamReceiver(cfg, n_channels // D, frames_per_step,
                               device=d) for d in mesh.devices]
        self.device = resolve_device(device)
        self.cfg = cfg
        self.fec = FECStage(cfg, self.device)
        self.frame_len = L = self.fec.frame_len
        self.payload_len = self.fec.payload_len
        self.n_channels = n_channels
        self.F = F = frames_per_step
        self.n_out = F * L
        self.n_in = self.n_out * cfg.sps
        self.sync = FeedForwardSync(
            sps=cfg.sps, rolloff=cfg.rolloff, max_block=self.n_out,
            device=self.device,
        )
        self._hist = self.sync.history()
        self._n_fe = self.n_in + self._hist
        self.N_BUF = self.n_in + self._hist + L * cfg.sps + 1024
        self._settle0 = int((TAIL + self.N_BUF / cfg.sps) // L + 2)
        self._lane = make_lane_fn(cfg, self.fec.descr)
        # payload k of a step's window starts at row k L + 92 of the window
        self._pay_off = np.arange(F, dtype=np.int64) * L + 92

    # ---------------- state ----------------

    def init_state_np(self):
        """Zero state as a host dict (same keys and dtypes as the JAX
        ``StreamReceiver.init_state_np``)."""
        C = self.n_channels
        return {
            "sbuf": np.zeros((C, self.N_BUF, 2), np.float32),
            "sfill": np.zeros((C,), np.int32),
            "ff_tau": np.zeros((C,), np.float32),
            "ff_rate": np.zeros((C,), np.float32),
            "ff_init": np.zeros((C,), np.int32),
            "rot_phase": np.zeros((C,), np.float32),
            "rot_inc": np.zeros((C,), np.float32),
            "agc_gain": np.ones((C,), np.float32),
            "sym_tail": np.zeros((C, TAIL, 2), np.float32),
            "fp": np.full((C,), FP0, np.int32),
            "coarse_acc": np.zeros((C, 89, 2), np.float32),
            "coarse_frames": np.zeros((C,), np.int32),
            "coarse_foffset": np.zeros((C,), np.float32),
            "coarse_corrected": np.zeros((C,), bool),
            "cum_foffset": np.zeros((C,), np.float32),
            "settle": np.zeros((C,), np.int32),
            "unlock_cnt": np.zeros((C,), np.int32),
            "n0_refined": np.zeros((C,), np.float32),
        }

    def put_iq(self, iq_block):
        """One (C, n, 2) float32 host block onto the device, or under a
        mesh one block of C/D channels onto each shard's device."""
        if self.mesh is None:
            return super().put_iq(iq_block)
        return self.mesh.split(iq_block, 0)

    def put_state(self, state_np):
        """A host state dict (``init_state_np``'s keys, e.g. a JAX state
        read out as numpy) onto the device, or split over the mesh."""
        if self.mesh is None:
            return state_from_numpy(state_np, self.device)
        return sharded_state_from_numpy(state_np, self.mesh)

    def _recent(self, blocks, n):
        """The last ``n`` samples of a run of device blocks (per shard under
        a mesh)."""
        if self.mesh is None:
            return torch.cat(blocks, dim=1)[:, -n:]
        return [torch.cat(p, dim=1)[:, -n:] for p in zip(*blocks)]

    # ---------------- the step ----------------

    def _windows(self, sym_all, fp):
        """(C, T, 2) symbols + per-channel fp -> (hdr (C, F+1, 91, 2),
        hdr3 (C, F+1, 3, 91, 2) early/on-time/late, the window's first row
        (C,) int64). The payloads stay in ``sym_all``: the lane program
        reads payload k at row ``first + k L + 92``."""
        F, L = self.F, self.frame_len
        W = F * L + 94
        first = (fp.to(torch.int64) - 2).clamp(0, sym_all.shape[1] - W)
        w = _window(sym_all, first, W)
        hdr = torch.stack(
            [w[:, k * L + 1: k * L + 92] for k in range(F + 1)], dim=1)
        hdr3 = torch.stack([
            torch.stack([w[:, k * L + 1 + d: k * L + 92 + d]
                         for k in range(F + 1)], dim=1)
            for d in (-1, 0, 1)
        ], dim=2)
        return hdr, hdr3, first

    def _slip_metric(self, hdr3):
        """Mean frame metric per (channel, early/on-time/late): (C, 3)."""
        d = cplx.conj_mul(hdr3[..., 1:, :], hdr3[..., :-1, :])
        return plsync.frame_metric(d[..., 1:, :]).mean(dim=1)

    def step(self, state, iq):
        """One step: state dict + iq (C, n_in, 2) float32 on the device ->
        (new state, kbytes (C, F, kbch/8) uint8 scrambled, stats).

        Under a mesh: the list of shard states + iq (a host or device
        block, or ``put_iq``'s list) -> (the list of new shard states, and
        kbytes and stats equal to the unsharded step's: channel-led leaves
        concatenated on the first device, the whole-step scalars combined
        as ``SHARD_REDUCE`` says: ``bch_errors`` and the LDPC counters
        summed, ``ldpc_iters`` the maximum over the shards). Each shard's
        step takes the BCH form that reads nothing back, so queuing one
        shard never waits on another's card."""
        if self.mesh is None:
            return self._step(state, iq, sync_free=False)
        outs = []
        for loc, st, x in zip(self._shards, state, self.put_iq(iq)):
            with Mesh.on(loc.device):
                outs.append(loc._step(st, x, sync_free=True))
        return ([o[0] for o in outs],
                self.mesh.gather([o[1] for o in outs]),
                self.mesh.merge([o[2] for o in outs], SHARD_REDUCE))

    def make_scan_step(self, T: int):
        """T chained steps per call: ``scan(state, blocks (T, C, n_in, 2))
        -> (state', kbytes (T, C, F, kbch/8), stats)``, every stats leaf
        stacked over T (the JAX ``make_scan_step``) but the LDPC counters,
        summed (``CALL_SUMS``). See ``ScanStep``."""
        return ScanStep(self, T)

    def _step(self, state, iq, sync_free):
        """One step through the stages of ``utils.spans.STAGES``, each
        under its span."""
        cfg = self.cfg
        C, F, n_out = self.n_channels, self.F, self.n_out
        B = C * F
        sps = cfg.sps
        dev = self.device
        with span("inputs", dev):
            iq = torch.as_tensor(iq, device=dev)
        with span("frontend", dev):
            st, syms, overflow, underflow = self._frontend(state, iq)
        with span("windows", dev):
            sym_all = torch.cat([st["sym_tail"], syms], dim=1)  # (C, T, 2)
            fp = st["fp"]
            hdr, hdr3, first = self._windows(sym_all, fp)

        # ---- per-lane PL processing + demap (lane b = c*F + f), the
        # payloads read in place from sym_all ----
        with span("plsync", dev):
            start = (first[:, None] + device_table(self._pay_off, fp.device)
                     ).reshape(B)
            sym = sym_all[:, None].expand((C, F) + sym_all.shape[1:])
            n0_ov = torch.where(st["n0_refined"] > 0, st["n0_refined"],
                                -1.0).repeat_interleave(F)
            cc = st["coarse_corrected"].repeat_interleave(F)
            out = self._lane(hdr[:, :F, 1:], hdr[:, 1:, 1:], sym, start, cc,
                             n0_ov, x_every=F)
        with span("fec", dev):
            kbytes, n_corr, frame_iters, ok, hard_t = self.fec.lane_major(
                out["llrs"], sync_free)
            iters = frame_iters.max()
            ts_ok, hdr_ok = packet_validity(
                kbytes ^ self.fec.bb_scramble[None])

        # ---- post-decoder SNR refinement (frame 0 of each channel) ----
        with span("snr", dev):
            xfec_c = out["x0"]
            hard_c = hard_t[:, ::F].t()
            snr_ref, n0_refined = _snr_refine_n0(
                xfec_c, hard_c, cfg.constellation, cfg.rate,
                cfg.pls_info.n_mod, st["n0_refined"])

        with span("tracking", dev):
            # ---- frame-alignment tracking (slips from the timing loop) ----
            m3 = self._slip_metric(hdr3)                         # (C, 3)
            center = m3[:, 1]
            shift = torch.where(center + 1e-3 >= m3.max(dim=1).values, 0,
                                m3.argmax(dim=1) - 1)
            fp = (fp + shift).clamp(FP_MIN, FP_MAX)

            # ---- lock maintenance ----
            m_frames = out["metric"].reshape(C, F, 2)[:, :, 0]
            unlock = st["unlock_cnt"]
            for k in range(F):
                unlock = torch.where(
                    m_frames[:, k] > plsync.THRESHOLD_LOCKED, 0, unlock + 1)
            locked = unlock < cfg.unlock_thresh

            # ---- coarse accumulation with settle gating ----
            acc = st["coarse_acc"]
            cf = st["coarse_frames"]
            settle = st["settle"]
            corrected = st["coarse_corrected"]
            coarse_est = st["coarse_foffset"]
            autocorr = out["autocorr"].reshape(C, F, 89, 2)
            new_coarse = torch.zeros((C,), dtype=torch.bool, device=fp.device)
            for k in range(F):
                in_settle = settle > 0
                settle = torch.where(in_settle, settle - 1, settle)
                skip = in_settle & ~corrected
                acc = torch.where(skip[:, None, None], acc,
                                  acc + autocorr[:, k])
                cf = torch.where(skip, cf, cf + 1)
                fire = cf >= cfg.coarse_period
                est_new = plsync.coarse_foffset_from_autocorr(acc)
                coarse_est = torch.where(fire, est_new, coarse_est)
                corrected = torch.where(
                    fire, est_new.abs() < plsync.FINE_FOFFSET_CORR_RANGE,
                    corrected)
                acc = torch.where(fire[:, None, None], 0.0, acc)
                cf = torch.where(fire, 0, cf)
                new_coarse = new_coarse | fire

            # ---- closed-loop rotator update ----
            fine = out["fine"].reshape(C, F)
            cum = st["cum_foffset"]
            rot_inc = st["rot_inc"]
            if cfg.closed_loop:
                can = settle <= 0
                adj = torch.where(corrected, fine[:, -1],
                                  torch.where(new_coarse, coarse_est, 0.0))
                adj = torch.where(can, adj, 0.0)
                applied = adj != 0.0
                cum = cum + adj
                rot_inc = torch.where(applied, -cum * (2 * np.pi) / sps,
                                      rot_inc)
                settle = torch.where(applied, self._settle0, settle)
                wipe = applied & ~corrected
                acc = torch.where(wipe[:, None, None], 0.0, acc)
                cf = torch.where(wipe, 0, cf)

        with span("outputs", dev):
            new_state = dict(
                st, sym_tail=sym_all[:, n_out:], fp=fp, coarse_acc=acc,
                coarse_frames=cf, coarse_foffset=coarse_est,
                coarse_corrected=corrected, cum_foffset=cum, settle=settle,
                rot_inc=rot_inc, unlock_cnt=unlock, n0_refined=n0_refined,
            )
            new_state = {k: v.to(state[k].dtype)
                         for k, v in new_state.items()}
            stats = {
                "metric": center,
                "locked": locked,
                "bch_errors": (n_corr < 0).sum(),
                "ldpc_iters": iters,
                # the decoder's work: iterations over the step's frames,
                # and the frames whose parity check passed
                "ldpc_frame_iters": frame_iters.sum(dtype=torch.int32),
                "ldpc_converged": ok.sum(dtype=torch.int32),
                "n0": out["n0"].reshape(C, F)[:, 0],
                "snr_refined": snr_ref,
                "coarse_foffset": new_state["coarse_foffset"],
                "fine_foffset": fine[:, -1],
                "coarse_corrected": new_state["coarse_corrected"],
                "cum_foffset": new_state["cum_foffset"],
                "fp": new_state["fp"],
                "ts_ok": ts_ok.reshape(C, F, -1),
                "hdr_ok": hdr_ok.reshape(C, F),
                "sfill": new_state["sfill"],
                "overflow": overflow,
                "underflow": underflow,
            }
        return new_state, kbytes.reshape(C, F, -1), stats

    # ---------------- re-acquisition (device-side) ----------------

    def reacquire(self, state, iq_tail, mask):
        """Re-acquire the channels flagged in ``mask`` ((C,) bool) from the
        latest ``n_fe`` raw samples (``iq_tail``: (C, n_fe, 2) float32 on
        the device). Returns (state', ok): the priming math on the tail,
        spliced into the carried state with masked merges; CFO knowledge
        (rotator increment, cumulative offset, coarse-corrected flag)
        survives. Under a mesh the tail and mask are split (or the tail
        comes as a list per shard), each shard re-acquires its channels and
        ``ok`` comes back whole on the first device."""
        if self.mesh is not None:
            outs = []
            for loc, st, x, m in zip(self._shards, state,
                                     self.mesh.split(iq_tail, 0),
                                     self.mesh.split(mask, 0)):
                with Mesh.on(loc.device):
                    outs.append(loc.reacquire(st, x, m))
            return ([o[0] for o in outs],
                    self.mesh.gather([o[1] for o in outs]))
        cfg = self.cfg
        C, L = self.n_channels, self.frame_len
        n_out, n_fe, sps = self.n_out, self._n_fe, cfg.sps
        gain = state["agc_gain"]
        fe = frontend(iq_tail, gain, torch.zeros_like(gain), state["rot_inc"],
                      "given" if cfg.agc else "off")
        rot, phase = fe["out"], fe["phase"]
        ff2, syms, consumed = self.sync.step_batched(
            self.sync.init_state(C), rot, n_out)
        win = acq_metric(syms)[:, : L + 90]
        p = win.argmax(dim=1)
        found = win.gather(1, p[:, None])[:, 0] >= plsync.THRESHOLD_UNLOCKED
        ss = p - 89
        ss = torch.where(ss < FP0, ss + L, ss)
        m = torch.div(n_out - ss - (TAIL - FP0), L, rounding_mode="floor")
        E = ss + (TAIL - FP0) + m * L
        r = n_out - E
        start = consumed - r * sps
        pad = torch.zeros((C, max(self.N_BUF - n_fe, 0), 2),
                          dtype=torch.float32, device=rot.device)
        sbuf = torch.cat([pad, rot], dim=1)[:, -self.N_BUF:]
        sfill = n_fe - start
        sym_tail = _window(syms, E - TAIL, TAIL)
        ok = mask & found

        def mk(new, old):
            return torch.where(ok.reshape((C,) + (1,) * (old.ndim - 1)),
                               new.to(old.dtype), old)

        zc = torch.zeros((C,), dtype=torch.int32, device=rot.device)
        new_state = dict(
            state,
            sbuf=mk(sbuf, state["sbuf"]),
            sfill=mk(sfill, state["sfill"]),
            ff_tau=mk(ff2.tau, state["ff_tau"]),
            ff_rate=mk(ff2.rate, state["ff_rate"]),
            ff_init=mk(ff2.initialized, state["ff_init"]),
            rot_phase=mk(phase, state["rot_phase"]),
            sym_tail=mk(sym_tail, state["sym_tail"]),
            fp=mk(torch.full_like(zc, FP0), state["fp"]),
            coarse_acc=mk(torch.zeros_like(state["coarse_acc"]),
                          state["coarse_acc"]),
            coarse_frames=mk(zc, state["coarse_frames"]),
            unlock_cnt=mk(zc, state["unlock_cnt"]),
        )
        return new_state, ok

    # ---------------- priming (host-side acquisition) ----------------

    def prime(self, iq_prefix: np.ndarray, strict: bool = True):
        """Acquire from the first samples and build the steady-state carry.

        iq_prefix: (C, n) complex64, n >= n_in + history. Runs one front-end
        block on the device, finds the SOF with the dense timing metric,
        and rewinds the sample buffer by whole symbols so the next step's
        frame group starts at ``FP0`` inside the carried tail. Returns the
        device state. With ``strict=False`` a channel without a SOF peak
        keeps the zero state and is reported in ``self.prime_ok``.
        """
        cfg = self.cfg
        C, sps = self.n_channels, cfg.sps
        L = self.frame_len
        n_out, n_fe = self.n_out, self._n_fe
        if iq_prefix.shape[0] != C:
            raise ValueError(f"expected {C} channels")
        if iq_prefix.shape[1] < n_fe:
            raise ValueError(f"prime needs >= {n_fe} samples per channel")
        # at full width on the first device, also under a mesh
        iq = super().put_iq(
            cplx.from_np(iq_prefix[:, :n_fe]).astype(np.float32))
        iq, gain = prime_agc(iq, cfg)
        ff2, syms_d, consumed_d = self.sync.step_batched(
            self.sync.init_state(C), iq, n_out)
        metric = acq_metric(syms_d).cpu().numpy()
        syms = syms_d.cpu().numpy()
        consumed = consumed_d.cpu().numpy()
        rotated = iq.cpu().numpy()

        state = self.init_state_np()
        first_sof = np.zeros((C,), np.int64)
        prime_ok = np.ones((C,), bool)
        for c in range(C):
            p = int(np.argmax(metric[c, : L + 90]))
            if metric[c, p] < plsync.THRESHOLD_UNLOCKED:
                if strict:
                    raise RuntimeError(
                        f"prime: no SOF found on channel {c} "
                        f"(peak {metric[c, p]:.1f})"
                    )
                prime_ok[c] = False
                continue
            ss = p - 89
            if ss < FP0:
                ss += L
            m = (n_out - ss - (TAIL - FP0)) // L
            E = ss + (TAIL - FP0) + m * L
            r = n_out - E
            start = int(consumed[c]) - r * sps
            tail_samples = rotated[c, start:n_fe]
            state["sbuf"][c, self.N_BUF - tail_samples.shape[0]:] = \
                tail_samples
            state["sfill"][c] = tail_samples.shape[0]
            state["sym_tail"][c] = syms[c, E - TAIL: E]
            first_sof[c] = ss
        state["ff_tau"] = ff2.tau.cpu().numpy()
        state["ff_rate"] = ff2.rate.cpu().numpy()
        state["ff_init"] = ff2.initialized.cpu().numpy()
        state["agc_gain"] = gain.cpu().numpy()
        self._first_sof = first_sof
        self.prime_ok = prime_ok
        return self.put_state(state)


def _chain(sr, state, blocks):
    """T = len(blocks) steps of one unsharded receiver, each with the BCH
    form that reads nothing back; outputs stacked over T, the
    ``CALL_SUMS`` counters summed over it."""
    kbs, stats = [], []
    for t in range(blocks.shape[0]):
        state, kb, st = sr._step(state, blocks[t], sync_free=True)
        kbs.append(kb)
        stats.append(st)
    # the stacking over T: the last step's outputs stage
    with span("outputs"):
        out = {}
        for k in stats[0]:
            v = torch.stack([st[k] for st in stats])
            out[k] = v.sum(0, dtype=v.dtype) if k in CALL_SUMS else v
        return state, torch.stack(kbs), out


class _GraphChain:
    """One receiver's T chained steps captured as one CUDA graph.

    Static inputs: a copy of the state and a (T, C, n_in, 2) block buffer.
    The capture follows PyTorch's graph recipe: one warm-up step on a side
    stream first, which builds everything the step creates lazily (the
    LDPC kernel's tables, ``device_table`` entries, cuBLAS's workspace,
    the kernels' shared-memory attributes), since a host-to-device copy or
    a sync inside a capture is an error. The graph
    ends by copying the final state into the static state, so a call fed
    the state the last call returned copies nothing (JAX's donation).
    The capture records where each stage of each step begins
    (``utils.spans.layout``; ``layout.stages``). A call that a
    ``torch.profiler`` profile records puts its copies into the static
    buffers in the ``inputs`` range and records in the trace how many
    device events they make and the layout, so its device events split
    by stage; it launches nothing more, and the graph is the same with or
    without a profile."""

    def __init__(self, sr, state, blocks):
        self.device = dev = sr.device
        self.state_in = {k: v.clone() for k, v in state.items()}
        self.blocks_in = blocks.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _chain(sr, self.state_in, self.blocks_in[:1])
        torch.cuda.current_stream(dev).wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph), \
                spans.layout(dev) as self.layout:
            st, kbs, stats = _chain(sr, self.state_in, self.blocks_in)
            with span("outputs"):
                for k, v in st.items():
                    if v is not self.state_in[k]:
                        self.state_in[k].copy_(v)
        # kernel launches the graph holds, replayed on every call
        self.launches = {k: n - before[k]
                         for k, n in launch_counts().items()}
        self.out = (self.state_in, kbs, stats)

    def __call__(self, state, blocks):
        traced = spans.profiling()
        with span("inputs", None, traced):
            head = 1                        # device events before the replay
            for k, v in state.items():
                if v is not self.state_in[k]:
                    self.state_in[k].copy_(v)
                    head += v.numel() > 0
            self.blocks_in.copy_(blocks)
            if traced:
                self.layout.record(head)
        self.graph.replay()
        return self.out


class ScanStep:
    """``StreamReceiver.make_scan_step(T)``: ``scan(state, blocks (T, C,
    n_in, 2)) -> (state', kbytes (T, C, F, kbch/8), stats)``, every stats
    leaf stacked over T, the same values as T calls of ``step`` (JAX
    ``make_scan_step``, a ``lax.scan`` in one dispatch), but the LDPC
    counters of ``CALL_SUMS``: one scalar a call, the sum of the T steps'.

    On CPU tensors a Python loop over the step. On the card one
    ``torch.cuda.CUDAGraph`` holding the T chained steps, captured on the
    first call and replayed on every call: each call copies its arguments
    into the graph's static buffers and runs one ``replay()``, with no host
    sync. The returned tensors are the graph's own buffers: they are valid
    until the next call of the same scan, which overwrites them (the
    counterpart of JAX's ``donate_argnums``); clone what must outlive it.
    A capture that fails raises; it never falls back to eager steps.

    Under a mesh: one graph per shard, each on its shard's device; state is
    the list of shard states, blocks are split along channels, and kbytes
    and stats come back merged as ``StreamReceiver.step`` merges them.
    ``launches_per_call`` is what the graphs hold: the kernel wrappers
    count their launches while a graph is captured, not when it replays.
    Each graph's ``layout.stages`` says how many device events each stage
    of each step puts into its replay."""

    def __init__(self, sr, T: int):
        self.sr, self.T = sr, T
        self._graphs = {}

    @property
    def launches_per_call(self):
        out = dict.fromkeys(launch_counts(), 0)
        for g in self._graphs.values():
            for k, n in g.launches.items():
                out[k] += n
        return out

    def __call__(self, state, blocks):
        sr = self.sr
        if sr.mesh is None:
            return self._local(0, sr, state, blocks)
        outs = [self._local(i, loc, st, b) for i, (loc, st, b) in enumerate(
            zip(sr._shards, state, sr.mesh.split(blocks, 1)))]
        return ([o[0] for o in outs],
                sr.mesh.gather([o[1] for o in outs], 1),
                sr.mesh.merge([o[2] for o in outs], SHARD_REDUCE, dim=1))

    def _local(self, i, sr, state, blocks):
        blocks = torch.as_tensor(blocks, device=sr.device)
        want = (self.T, sr.n_channels, sr.n_in, 2)
        if tuple(blocks.shape) != want:
            raise ValueError(f"blocks of shape {tuple(blocks.shape)}, "
                             f"expected {want}")
        if sr.device.type != "cuda":
            return _chain(sr, state, blocks)
        with Mesh.on(sr.device):
            g = self._graphs.get(i)
            if g is None:
                g = self._graphs[i] = _GraphChain(sr, state, blocks)
            return g(state, blocks)


class StreamSession:
    """Host policy around ``StreamReceiver``: prime, step, monitor lock,
    and re-acquire dropped channels from a short rolling window of the
    device input blocks."""

    def __init__(self, sr: StreamReceiver):
        self.sr = sr
        self.state = None
        self._blk_hist = []
        self._nblk = int(np.ceil(sr._n_fe / sr.n_in)) + 1
        self.need = np.zeros((sr.n_channels,), bool)
        self.reacquired = 0

    def prime(self, iq_prefix: np.ndarray):
        """Soft-prime: failed channels are queued for re-acquisition.
        Returns the per-channel success mask."""
        self.state = self.sr.prime(iq_prefix, strict=False)
        self.need = ~self.sr.prime_ok
        return self.sr.prime_ok.copy()

    def step(self, blk):
        """One stream step. ``blk``: (C, n_in, 2) float32, numpy or a
        device tensor (or ``put_iq``'s list under a mesh). Returns (kbytes,
        stats); reading ``locked`` and the buffer flags here waits for the
        step (the price of per-step lock monitoring)."""
        sr = self.sr
        dblk = blk if isinstance(blk, (torch.Tensor, list)) \
            else sr.put_iq(blk)
        self._blk_hist.append(dblk)
        if len(self._blk_hist) > self._nblk:
            self._blk_hist.pop(0)
        self.state, kb, stats = sr.step(self.state, dblk)
        with span("session.readback"):
            flags = torch.stack([~stats["locked"], stats["underflow"],
                                 stats["overflow"]]).cpu().numpy()
        self.need |= flags.any(axis=0)
        have = len(self._blk_hist) * sr.n_in      # blocks of one step each
        if self.need.any() and have >= sr._n_fe:
            tail = sr._recent(self._blk_hist, sr._n_fe)
            mask = torch.as_tensor(self.need, device=sr.device)
            self.state, ok = sr.reacquire(self.state, tail, mask)
            ok = ok.cpu().numpy()
            self.reacquired += int(ok.sum())
            self.need &= ~ok
        return kb, stats


class StreamEngine:
    """Product host receiver driving the device-resident stream step.

    Same ``receive()/get_stats()/stats`` surface as the JAX
    ``StreamEngine``: chunked input of any size is re-blocked to the step
    size, priming is soft, re-acquisition automatic (``StreamSession``),
    and TS bytes are stitched on the host (native whole-step stitch when
    the extension is built) by a reader thread, so the device->host fetch
    overlaps the next steps. ``receive`` takes (C, n) complex IQ and
    returns per-channel TS byte arrays (a flat array for one channel).
    With ``mesh`` the receiver is sharded over a channel mesh.
    """

    get_stats = get_stats

    def __init__(self, cfg: RxConfig, n_channels: int = 1,
                 frames_per_step: int = 2, device=None, mesh: Mesh = None):
        self.cfg = cfg
        self.sr = StreamReceiver(cfg, n_channels=n_channels,
                                 frames_per_step=frames_per_step,
                                 device=device, mesh=mesh)
        self.sess = StreamSession(self.sr)
        self.n_channels = n_channels
        self.stats = RxStats()
        self.frame_len = self.sr.frame_len
        self._scr = bb_derandomizer_bytes(cfg.fec.kbch // 8)
        self._stitcher = BatchTSStitcher(n_channels)
        self.bb_parser = self._stitcher
        self._buf = np.empty((n_channels, 0), np.complex64)
        self._primed = False
        self._was_locked = np.zeros((n_channels,), bool)
        self._fetchq = _queue.Queue(maxsize=4)
        self._done = []
        self._done_lock = threading.Lock()
        self._reader_err = None
        self._reader = threading.Thread(target=self._reader_loop, daemon=True)
        self._reader.start()

    def close(self):
        """Stop the reader thread (pending fetches are stitched first)."""
        if self._reader.is_alive():
            self._fetchq.put(None)
            self._reader.join(timeout=60)

    def _update_stats(self, stats):
        s = self.stats
        C, F = self.n_channels, self.sr.F
        locked = stats["locked"].cpu().numpy()
        now_locked = bool(locked.all())
        if now_locked and not s.locked:
            s.lock_cnt += 1
            s.lock_time = time.time()
        if (~locked & self._was_locked).any():
            s.unlock_cnt += int((~locked & self._was_locked).sum())
        self._was_locked = locked
        s.locked = now_locked
        nf = int(locked.sum()) * F
        s.sof_cnt += nf
        s.frame_cnt += nf
        s.coarse_foffset = float(stats["coarse_foffset"][0])
        s.fine_foffset = float(stats["fine_foffset"][0])
        s.cum_freq_offset = float(stats["cum_foffset"][0])
        s.coarse_corrected = bool(stats["coarse_corrected"].all())
        snr = float(stats["snr_refined"][0])
        if snr > 0:
            s.snr_db = 10.0 * np.log10(snr)
        errs = int(stats["bch_errors"])
        s.bch_frames += C * F
        s.bch_frame_errors += errs
        s.ldpc_frames += C * F
        s.ldpc_total_iters += int(stats["ldpc_iters"]) * C * F

    def _stitch(self, kb_np, ok_np, hdr_np):
        return self._stitcher.push_step(kb_np ^ self._scr[None, None], ok_np,
                                        hdr_np)

    def _reader_loop(self):
        while True:
            item = self._fetchq.get()
            if item is None:
                self._fetchq.task_done()
                return
            kb, ts_ok, hdr_ok = item
            try:
                with span("engine.stitch"):
                    parts = self._stitch(kb.cpu().numpy(),
                                         ts_ok.cpu().numpy(),
                                         hdr_ok.cpu().numpy())
                with self._done_lock:
                    self._done.append(parts)
            except Exception as e:      # surfaced on the feeding thread
                self._reader_err = e
            finally:
                self._fetchq.task_done()

    def _drain_done(self, ts):
        if self._reader_err is not None:
            raise self._reader_err
        with self._done_lock:
            done, self._done = self._done, []
        for parts in done:
            for c, t in enumerate(parts):
                ts[c].append(t)

    def receive(self, iq: np.ndarray, flush: bool = True):
        """Process IQ samples; returns the recovered TS bytes (flat uint8
        array for one channel, a list of arrays for several). A final
        remainder shorter than one step is buffered, and dropped at the end
        of the stream like the reference's in-flight tail. Host spans
        (``utils.spans.HOST``, while spans are on): the re-blocking, the
        session's readback, the statistics and the reader's stitch."""
        iq = np.asarray(iq, dtype=np.complex64)
        if iq.ndim == 1:
            iq = iq[None]
        if iq.shape[0] != self.n_channels:
            raise ValueError(f"expected {self.n_channels} channel rows")
        with span("engine.reblock"):
            self._buf = np.concatenate([self._buf, iq], axis=1)
        sr = self.sr
        ts = [[] for _ in range(self.n_channels)]
        if not self._primed and self._buf.shape[1] >= sr._n_fe:
            self.sess.prime(self._buf[:, : sr._n_fe])
            self._buf = self._buf[:, sr._n_fe:]
            self._primed = True
        while self._primed and self._buf.shape[1] >= sr.n_in:
            with span("engine.reblock"):
                blk = cplx.from_np(self._buf[:, : sr.n_in]).astype(
                    np.float32)
                self._buf = self._buf[:, sr.n_in:]
            kb, stats = self.sess.step(blk)
            with span("engine.stats"):
                self._update_stats(stats)
            self._fetchq.put((kb, stats["ts_ok"], stats["hdr_ok"]))
            self._drain_done(ts)
        if flush:
            self._fetchq.join()
            self._drain_done(ts)
        out = [np.concatenate(t) if t else np.empty(0, np.uint8) for t in ts]
        return out[0] if self.n_channels == 1 else out
