"""Device-resident ACM/VCM stream receiver: variable-MODCOD IQ -> TS.

Port of ``dvbs2rx_tpu/rx/vcm_stream.py``: ``VCMStreamReceiver``
(``init_state_np``, ``prime``, ``step``, ``flush``, ``reacquire``) and
``VCMStreamEngine`` (soft priming, automatic re-acquisition, per-channel
reorder by sequence number, per-PLS statistics). Each frame's decoded PLSC
decides where the next frame starts, so one step composes:

- the front end of the CCM stream receiver (AGC, rotator, feed-forward
  timing through ``ops.ffsync``, so through the matched-filter kernel
  ``csrc/mf_segmented.cu`` on the card), appending to a symbol ring;
- the decoded-PLS chain walk over ``K_max`` frame slots: a 94-symbol
  window at the predicted start of the next frame, a 3-point
  early/on-time/late metric, the PLSC decode (differential until the coarse
  CFO is corrected, then ``cfg.plsc_mode``), and the PLS -> frame length
  table; with its books over the walked slots: the data slots compacted
  to (C, F_pay) lanes, lock upkeep and the full-PLHEADER coarse CFO; on
  the card one launch of ``csrc/vcm_walk.cu`` a step
  (``ops.vcm_walk_cuda``), on the CPU the plain composite
  ``_walk_books_plain`` (the loop ``_walk_plain``, then the books);
- the PLHEADER kernel (``csrc/plsync.cu``) over the lanes (header
  phases), then per expected PLS the payload kernels (descramble, fine
  CFO, phase correction, SNR, demap, int8 LLRs) over the lanes that
  decoded to it, reading the ring in place;
- the closed-loop rotator;
- per expected PLS, a pooled FEC queue (frames from every channel and
  step) that decodes full ``B_fec``-frame batches with the LDPC kernel
  ``csrc/ldpc_layered.cu`` and BCH, and carries a refined N0 per (channel,
  PLS) from the decoded bits.

What the JAX module does only for the TPU is not ported; its numeric
contracts are kept. Table lookups and the compaction of data slots and
selected lanes are indexes and scatters by rank (the JAX one-hot and bf16
permutation matmuls give the same values). The symbol ring is planar
``(C, N_SYM, 2)`` and the queues hold one frame per row, ``(S, CAP, N)``
and ``(S, CAP, 2 R_SUB)``, where the JAX state is rail-major and
lane-major: ``convert.vcm_state_from_numpy`` / ``vcm_state_to_numpy``
transpose those three leaves. ``init_state_np`` and ``flush`` keep the JAX
layouts and shapes.

The JAX drain is a ``lax.cond`` inside a ``lax.scan``; here the step reads
the S queue fills back once, after every PLS's append, and runs the full
batches from a host loop. A batch is decoded only when it is full, so
``outputs["fired"]`` is the JAX program's, step for step. Host
synchronisation points of one step: that readback, and the BCH all-clean
flag of each decoded batch. The step is functional: it never writes the
tensors of the state it was given.
"""

import time

import numpy as np
import torch
import torch.nn.functional as Fn

from ..convert import vcm_state_from_numpy
from ..ops import cplx, plsync, plsync_cuda
from ..ops.crc8_dev import packet_validity
from ..ops.ffsync import FeedForwardSync
from ..ops.frontend_cuda import frontend
from ..ops.vcm_walk_cuda import vcm_walk
from ..spec.bb_frame import BBFrameParser
from ..spec.fec_params import DVBS2_MODCODS as _MODCODS
from ..spec.fec_params import get_fec_info
from ..spec.pls import parse_pls
from ..spec.scramblers import bb_derandomizer_bytes, pl_descrambling_sequence
from ..utils.runtime import device_table, resolve_device
from ..utils.spans import span
from .receiver import (
    _BYTE_W,
    _PLSC_DECODERS,
    RxStats,
    _snr_refine_frames,
    acq_metric,
    get_bch_decoder,
    get_ldpc_decoder,
    get_stats,
)
from .stream import StreamFrontEnd, _window, prime_agc

DUMMY_PLFRAME_LEN = 3330      # the shortest frame, so the walk's slot bound
GAP_SKIP_STEPS = 8            # steps a channel waits on a missing seq


class VCMStreamReceiver(StreamFrontEnd):
    """Variable-MODCOD multi-channel receiver as one device step.

    ``step(state, iq) -> (state', outputs, stats)`` with ``iq`` of shape
    (C, n_in, 2) float32 on the receiver's device. ``outputs`` holds, per
    expected PLS, ``DRAIN`` slots of decoded ``B_fec``-frame batches (see
    ``step``).

    ``allow_dummy`` (default True) sizes the chain walk for dummy frames,
    the shortest there are; False sizes it for the smallest expected data
    frame (a stream that carries no dummies), as the JAX receiver does.
    """

    # the BCH form that reads nothing back (``ops.bch``): set on the local
    # receivers of a mesh (``parallel.vcm_shard``)
    _bch_sync_free = False

    def __init__(self, cfg, n_channels: int, frames_per_step: int = 2,
                 fec_lanes: int = None, device=None,
                 allow_dummy: bool = True):
        if not cfg.acm_vcm:
            raise ValueError("VCMStreamReceiver requires acm_vcm=True")
        if cfg.sym_sync_impl != "ffw":
            raise ValueError("VCMStreamReceiver requires sym_sync_impl='ffw'")
        if not cfg.closed_loop:
            raise ValueError("VCMStreamReceiver requires closed_loop=True")
        expected = tuple(cfg.pls_expected or cfg.pls_list)
        if not expected:
            raise ValueError(
                "VCMStreamReceiver needs the a-priori PLS set "
                "(cfg.pls_expected or cfg.pls_list); the fully-blind search "
                "path is the host ACMReceiver"
            )
        infos = [parse_pls(p) for p in expected]
        if any(i.dummy_frame for i in infos):
            raise ValueError("dummy PLS values need not be listed")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.n_channels = C = n_channels
        self.pls_set = expected
        self.S = S = len(expected)
        self._infos = infos
        # per-PLS frame size; queues pad to the largest code
        self._framesizes = [
            "short" if i.short_fecframe else "normal" for i in infos
        ]
        self._fecs = [
            get_fec_info(fs, _MODCODS[i.modcod][1])
            for fs, i in zip(self._framesizes, infos)
        ]
        self.n_ldpc = max(f.nldpc for f in self._fecs)
        self.kb_max = max(f.kbch for f in self._fecs) // 8

        # geometry
        self.L_max = max(i.plframe_len for i in infos)
        self.Lp_max = self.L_max - 90
        L_min_data = min(i.plframe_len for i in infos)
        L_min_walk = DUMMY_PLFRAME_LEN if allow_dummy else L_min_data
        self.n_out = frames_per_step * self.L_max
        self.n_in = self.n_out * cfg.sps
        self.K_max = self.n_out // L_min_walk + 2
        self.F_pay = self.n_out // L_min_data + 2
        self.B_lanes = C * self.F_pay
        if fec_lanes is None:
            # the LDPC kernel runs one block per frame: 128 frames keep the
            # card's 132 SMs busy; the CPU takes the JAX package's 16
            fec_lanes = 128 if dev.type == "cuda" else 16
        self.B_fec = fec_lanes
        self.DRAIN = max(1, -(-self.B_lanes // self.B_fec))
        self.CAP = self.B_fec + self.B_lanes + 8

        # front end (the CCM stream receiver's)
        self.sync = FeedForwardSync(
            sps=cfg.sps, rolloff=cfg.rolloff, max_block=self.n_out, device=dev,
        )
        self._hist = self.sync.history()
        self._n_fe = self.n_in + self._hist
        self.N_BUF = self.n_in + self._hist + self.L_max * cfg.sps + 1024
        # symbol ring: one step's append + the priming backlog
        self.N_SYM = 2 * self.n_out + 128
        self._settle0 = int(
            (self.N_SYM + self.N_BUF / cfg.sps) // L_min_data + 2
        )

        # spec tables, on the device once
        self._L_tab = torch.as_tensor(
            [parse_pls(p).plframe_len for p in range(128)], device=dev)
        self._dummy_tab = torch.as_tensor(
            [parse_pls(p).dummy_frame for p in range(128)], device=dev)
        enabled = np.zeros(128, bool)
        out_filter = tuple(cfg.pls_list) if cfg.pls_list else expected
        enabled[list(out_filter)] = True
        self._enabled_tab = torch.as_tensor(enabled, device=dev)
        mask = np.zeros(128, bool)
        mask[list(expected)] = True
        mask[:4] = True                      # dummies always searched
        self._search_mask = torch.as_tensor(mask, device=dev)
        self._plsc_coherent = _PLSC_DECODERS[cfg.plsc_mode]
        self._descr = torch.as_tensor(cplx.from_np(
            pl_descrambling_sequence(cfg.gold_code)[: self.Lp_max]),
            device=dev)

        # per-PLS resources
        self._ldpc = [
            get_ldpc_decoder(f.ldpc_table, cfg.ldpc_max_trials,
                             cfg.ldpc_algo, cfg.ldpc_update, dev)
            for f in self._fecs
        ]
        self._bch = [
            get_bch_decoder(fs, f.t, f.nbch, f.kbch, dev)
            for fs, f in zip(self._framesizes, self._fecs)
        ]
        self.bb_scramble = [
            bb_derandomizer_bytes(f.kbch // 8) for f in self._fecs
        ]
        # post-decoder SNR refinement: the pooled symbol-snapshot prefix
        # length and its int8 scale
        self.R_SUB = min(
            4096,
            min(f.nldpc // i.n_mod for f, i in zip(self._fecs, infos)),
        )
        self.XF_SCALE = 32.0
        # closed-loop coarse re-application floor: with a pilotless PLS
        # expected, the per-frame fine estimator aliases beyond 1/(2 L), so
        # fine applies only readings under 1/(4 L_max) and the continuously
        # firing full-PLHEADER coarse closes anything larger
        if all(i.has_pilots for i in infos):
            self._coarse_reapply_min = plsync.FINE_FOFFSET_CORR_RANGE
        else:
            self._coarse_reapply_min = 1.0 / (4.0 * self.L_max)

    # ---------------- state ----------------

    def init_state_np(self):
        """Zero state as a host dict in the JAX package's layout (same keys,
        shapes and dtypes as the JAX ``init_state_np``)."""
        C, S = self.n_channels, self.S
        return {
            "sbuf": np.zeros((C, self.N_BUF, 2), np.float32),
            "sfill": np.zeros((C,), np.int32),
            "ff_tau": np.zeros((C,), np.float32),
            "ff_rate": np.zeros((C,), np.float32),
            "ff_init": np.zeros((C,), np.int32),
            "rot_phase": np.zeros((C,), np.float32),
            "rot_inc": np.zeros((C,), np.float32),
            "agc_gain": np.ones((C,), np.float32),
            "symbuf": np.zeros((C, 2, self.N_SYM), np.float32),
            "symfill": np.zeros((C,), np.int32),
            "fp_right": np.zeros((C,), np.int32),
            "pls": np.zeros((C,), np.int32),
            "seq": np.zeros((C,), np.int32),
            "coarse_acc": np.zeros((C, 89, 2), np.float32),
            "coarse_frames": np.zeros((C,), np.int32),
            "coarse_foffset": np.zeros((C,), np.float32),
            "coarse_corrected": np.zeros((C,), bool),
            "cum_foffset": np.zeros((C,), np.float32),
            "settle": np.zeros((C,), np.int32),
            "unlock_cnt": np.zeros((C,), np.int32),
            "qllr": np.zeros((S, self.n_ldpc, self.CAP), np.int8),
            "qmeta": np.zeros((S, self.CAP, 2), np.int32),
            "qfill": np.zeros((S,), np.int32),
            "qxf": np.zeros((S, self.R_SUB * 2, self.CAP), np.int8),
            "n0_refined": np.zeros((C, S), np.float32),
        }

    # ---------------- step pieces ----------------

    def _append_symbols(self, state, iq):
        """The shared front end, then the step's symbols onto the ring."""
        state, syms, overflow, underflow = self._frontend(state, iq)
        n_out = self.n_out
        state = dict(
            state,
            symbuf=torch.cat([state["symbuf"][:, n_out:], syms], dim=1),
            symfill=(state["symfill"] + n_out).clamp(max=self.N_SYM),
        )
        return state, overflow, underflow

    def _hdr3_at(self, symbuf, pos):
        """94-symbol window [pos-2, pos+92) per channel and its 3-point
        metric, ``pos`` the nominal SOF. Returns (m3 (C, 3), ext (C, 94,
        2)): m3[:, o] is the frame metric at SOF offset o-1, whose header is
        ext[:, o+1 : o+91]."""
        ext = _window(symbuf, (pos - 2).clamp(0, self.N_SYM - 94), 94)
        wins = torch.stack([ext[:, o: o + 91] for o in range(3)], dim=1)
        d = cplx.conj_mul(wins[..., 1:, :], wins[..., :-1, :])
        return plsync.frame_metric(d[..., 1:, :]), ext

    @staticmethod
    def _realign(m3):
        """Offset of the best SOF of a 3-point metric: the centre unless a
        side beats it by more than 1e-3 (the first maximum wins a tie)."""
        keep = m3[:, 1] + 1e-3 >= m3.max(dim=1).values
        return torch.where(keep, 0, m3.argmax(dim=1) - 1)

    def _decode_plsc(self, hdr, corrected):
        """Per-channel PLSC decode: differential (CFO-robust) while not
        coarse-corrected, the configured coherent mode after."""
        mask = self._search_mask
        # the closed loop has removed the CFO: derotate by the SOF phase
        der = cplx.cmul(hdr, cplx.cexp(-plsync.sof_phase(hdr))[..., None, :])
        pls_c, _ = self._plsc_coherent(der, enabled_mask=mask)
        pls_d, _ = plsync.plsc_decode_diff(hdr, enabled_mask=mask)
        return torch.where(corrected, pls_c, pls_d).to(torch.int64)

    def _walk_books(self, state):
        """Decoded-PLS chain walk over K_max slots and its books: the data
        slots compacted to (C, F_pay) lanes, the lock and coarse-CFO
        recurrences over the walked slots, the per-channel counts. Returns
        ``_walk_books_plain``'s dict. On the card one launch of
        ``csrc/vcm_walk.cu`` (``ops.vcm_walk_cuda``); CPU tensors take the
        plain composite, ``_walk_books_plain``."""
        if not state["symbuf"].is_cuda:
            return self._walk_books_plain(state)
        return vcm_walk(state, self._search_mask, self._enabled_tab,
                        self.K_max, self.F_pay, self.L_max,
                        self.cfg.plsc_mode, self.cfg.coarse_period)

    def _walk_plain(self, state):
        """Decoded-PLS chain walk over K_max slots as a loop of PyTorch
        operations, slot by slot. Returns the slots (dict of (K, C, ...)
        tensors: pos, pls, valid, own_hdr, metric, next_pls, next_hdr), the
        carry's N_SYM - pos and PLS, and the number of frames walked per
        channel. Once a chain is dead at slot k, the carry is frozen, so
        slots k + 1 .. K_max - 1 repeat slot k."""
        symbuf = state["symbuf"]
        corrected = state["coarse_corrected"]
        fp0 = self.N_SYM - state["fp_right"].to(torch.int64)
        # first frame: 3-point re-align + header slice
        m3, ext = self._hdr3_at(symbuf, fp0)
        shift = self._realign(m3)
        pos = fp0 + shift
        own = _window(ext, shift + 2, 90)
        m_own = m3.gather(1, (shift + 1)[:, None])[:, 0]
        # a frame is walkable when the longest frame and the following
        # header fit inside the buffered symbols
        valid_lim = self.N_SYM - self.L_max - 92
        have = self.N_SYM - state["symfill"]
        alive = (pos <= valid_lim) & (pos >= have)
        pls = state["pls"].to(torch.int64)
        slots = {k: [] for k in ("pos", "pls", "valid", "own_hdr", "metric",
                                 "next_pls", "next_hdr")}
        for _ in range(self.K_max):
            nxt_nom = pos + self._L_tab[pls]
            m3n, extn = self._hdr3_at(symbuf, nxt_nom)
            shiftn = self._realign(m3n)
            nxt = nxt_nom + shiftn
            next_hdr = _window(extn, shiftn + 2, 90)
            next_pls = self._decode_plsc(next_hdr, corrected)
            m_next = m3n.gather(1, (shiftn + 1)[:, None])[:, 0]
            for k, v in (("pos", pos), ("pls", pls), ("valid", alive),
                         ("own_hdr", own), ("metric", m_own),
                         ("next_pls", next_pls), ("next_hdr", next_hdr)):
                slots[k].append(v)
            alive_n = alive & (nxt <= valid_lim)
            # a dead chain freezes: the first un-walked frame is the carry
            # the next step resumes from
            pos = torch.where(alive, nxt, pos)
            pls = torch.where(alive, next_pls, pls)
            own = torch.where(alive[:, None, None], next_hdr, own)
            m_own = torch.where(alive, m_next, m_own)
            alive = alive_n
        slots = {k: torch.stack(v) for k, v in slots.items()}
        n_walked = slots["valid"].sum(0, dtype=torch.int32)
        return slots, self.N_SYM - pos, pls, n_walked

    def _walk_books_plain(self, state):
        """``_walk_books`` in PyTorch: ``_walk_plain``, then the books over
        its (K, C) slots, in the JAX step's order (the kernel's plain
        version). Returns {"lanes": {pos, pls, next_pls (C, F_pay) int64,
        valid (C, F_pay) bool, own_hdr, next_hdr (C, F_pay, 90, 2)
        float32}: the first F_pay data slots of each channel in stream
        order, zeros after; "fp_right", "pls" (C,) int64: the carry's
        N_SYM - pos and PLS; "n_walked", "counts" (data slots, those past
        F_pay included), "dummies", "rejected", "unlock_cnt",
        "coarse_frames", "settle" (C,) int32; "coarse_acc" (C, 89, 2),
        "coarse_foffset", "metric_sum" (the walked slots' metrics) (C,)
        float32; "coarse_corrected", "new_coarse" (C,) bool}. The coarse
        recurrence evolves its own corrected flag; the walk and the demap
        keep the one the step started with."""
        C, K, FP = self.n_channels, self.K_max, self.F_pay
        dev = state["symbuf"].device
        slots, fp_right, new_pls, n_walked = self._walk_plain(state)
        valid, pls_s = slots["valid"], slots["pls"]              # (K, C)
        is_dummy = self._dummy_tab[pls_s]
        is_enabled = self._enabled_tab[pls_s]
        is_data = valid & ~is_dummy & is_enabled

        # ---- compact data slots to (C, F_pay) stream-ordered lanes: a
        # scatter by rank; slots past F_pay and non-data slots go to a
        # spill column that is dropped ----
        rank = torch.cumsum(is_data.to(torch.int64), dim=0) - 1    # (K, C)
        dst = torch.where(is_data & (rank < FP), rank, FP).t()     # (C, K)

        def compact(x):
            x = x.transpose(0, 1)                                 # (C, K,...)
            idx = dst.reshape(dst.shape + (1,) * (x.ndim - 2)).expand_as(x)
            out = torch.zeros((C, FP + 1) + x.shape[2:], dtype=x.dtype,
                              device=dev)
            return out.scatter(1, idx, x)[:, :FP]

        lanes = {k: compact(slots[k]) for k in ("pos", "pls", "next_pls",
                                                "own_hdr", "next_hdr")}
        lanes["valid"] = compact(is_data)

        # ---- lock maintenance over walked slots ----
        unlock = state["unlock_cnt"]
        for k in range(K):
            reset = slots["metric"][k] > plsync.THRESHOLD_LOCKED
            unlock = torch.where(valid[k], torch.where(reset, 0, unlock + 1),
                                 unlock)

        # ---- coarse CFO: full-PLHEADER accumulation over walked slots ----
        r_full = plsync.coarse_autocorr_plain(
            slots["own_hdr"].reshape(K * C, 90, 2), pls_s.reshape(K * C),
            full=True).reshape(K, C, 89, 2)
        acc = state["coarse_acc"]
        cf = state["coarse_frames"]
        settle = state["settle"]
        corrected = state["coarse_corrected"]
        coarse_est = state["coarse_foffset"]
        new_coarse = torch.zeros((C,), dtype=torch.bool, device=dev)
        for k in range(K):
            act = valid[k]
            in_settle = settle > 0
            settle = torch.where(act & in_settle, settle - 1, settle)
            skip = ~act | (in_settle & ~corrected)
            acc = torch.where(skip[:, None, None], acc, acc + r_full[k])
            cf = torch.where(skip, cf, cf + 1)
            fire = cf >= self.cfg.coarse_period
            est_new = plsync.coarse_foffset_from_autocorr(acc)
            coarse_est = torch.where(fire, est_new, coarse_est)
            corrected = torch.where(
                fire, est_new.abs() < plsync.FINE_FOFFSET_CORR_RANGE,
                corrected)
            acc = torch.where(fire[:, None, None], 0.0, acc)
            cf = torch.where(fire, 0, cf)
            new_coarse = new_coarse | fire

        i32 = torch.int32
        return {
            "lanes": lanes, "fp_right": fp_right, "pls": new_pls,
            "n_walked": n_walked, "unlock_cnt": unlock, "coarse_frames": cf,
            "settle": settle, "counts": is_data.sum(0, dtype=i32),
            "dummies": (valid & is_dummy).sum(0, dtype=i32),
            "rejected": (valid & ~is_dummy & ~is_enabled).sum(0, dtype=i32),
            "coarse_acc": acc, "coarse_foffset": coarse_est,
            "metric_sum": torch.where(valid, slots["metric"], 0.0).sum(0),
            "coarse_corrected": corrected, "new_coarse": new_coarse,
        }

    def _demap_lanes(self, si, sym, start, ph, corrected, n0_ov, sel, llr8,
                     xf, fine, n0):
        """Lane program of expected PLS ``si`` over the lanes set in
        ``sel`` (B,) bool, in place: sym (C, F_pay, N_SYM, 2) the ring as
        one view per lane, start (B,) each lane's payload row (clamped as a
        window of Lp_max), ph (B, 2, 2) the phases of the lane's header and
        of the next, corrected (B,) bool, n0_ov (B,) refined N0 (> 0
        overrides the data-aided one). Writes the selected lanes' int8 LLRs
        into llr8 (B, n_ldpc), their symbol snapshot x XF_SCALE into xf (B,
        2 R_SUB), the fine CFO into fine and the N0 demapped with into n0
        (B,); on the card the payload's statistics and demap kernels, one
        launch each; on the CPU their plain version."""
        info = self._infos[si]
        const, rate = _MODCODS[info.modcod]
        plsync_cuda.payload(
            sym, start, self.Lp_max, self._descr, ph, corrected, n0_ov, info,
            const, rate, llr8.t(), fine, n0, sel=sel,
            x_out=xf.view(-1, self.R_SUB, 2), x_scale=self.XF_SCALE,
            n0_use=True)

    def _step_a(self, state, iq):
        """Front end, walk and its books (lane compaction, lock upkeep,
        coarse CFO), per-PLS demap and selection, and the rotator, in the
        stages of ``utils.spans.VCM_STAGES`` before ``fec``. Returns
        (state', llr (B, n_ldpc) int8, as the payload kernels write it, xf
        (B, 2 R_SUB) float32 scaled symbol snapshots, meta (B, 2) int32
        (channel, seq), sels (S, B) bool, stats); lane b = c * F_pay + f
        (the JAX step returns llr and xf quantized)."""
        cfg = self.cfg
        C, FP, B = self.n_channels, self.F_pay, self.B_lanes
        dev = iq.device
        with span("frontend", dev):
            state, overflow, underflow = self._append_symbols(state, iq)
            symbuf = state["symbuf"]
            # the append moved every buffered symbol left by n_out
            state = dict(state, fp_right=state["fp_right"] + self.n_out)
        with span("walk", dev):
            books = self._walk_books(state)
            lanes = books["lanes"]
            fp_right, n_walked, counts = (books["fp_right"], books["n_walked"],
                                          books["counts"])

        with span("plsync", dev):
            # every lane's header and next header, with their decoded PLS: the
            # data-aided and tail phases; one launch on the card (empty lanes
            # carry zero headers and PLS 0: phase 0)
            hk = plsync_cuda.plheader(
                [lanes["own_hdr"], lanes["next_hdr"]],
                [lanes["pls"].reshape(B), lanes["next_pls"].reshape(B)])
            d_valid = lanes["valid"]                               # (C, FP)
            d_seq = state["seq"][:, None] + torch.arange(FP, device=dev,
                                                         dtype=torch.int32)

            # ---- lanes: payloads read in place from the ring (max
            # window) ----
            sym = symbuf[:, None].expand((C, FP) + symbuf.shape[1:])
            start_l = (lanes["pos"] + 90).reshape(B)
            ph_l = hk["phase"].reshape(B, 2, 2)
            pls_l = lanes["pls"].reshape(B)
            valid_l = d_valid.reshape(B)
            corrected_l = state["coarse_corrected"].repeat_interleave(FP)

            # ---- per-expected-PLS demap (static geometry) of the lanes that
            # decoded to it: each lane once, written in place ----
            llr8 = torch.zeros((B, self.n_ldpc), dtype=torch.int8, device=dev)
            xf = torch.zeros((B, self.R_SUB * 2), device=dev)
            fine = torch.zeros((B,), device=dev)
            n0 = torch.zeros((B,), device=dev)
            sels = []
            for si in range(self.S):
                n0_ov = state["n0_refined"][:, si].repeat_interleave(FP)
                sel = valid_l & (pls_l == self.pls_set[si])
                sels.append(sel)
                self._demap_lanes(si, sym, start_l, ph_l, corrected_l,
                                  n0_ov, sel, llr8, xf, fine, n0)
            meta = torch.stack([
                torch.arange(C, device=dev,
                             dtype=torch.int32).repeat_interleave(FP),
                d_seq.reshape(B),
            ], dim=1)
            sels = torch.stack(sels)                                   # (S, B)

        with span("tracking", dev):
            # ---- lock and coarse CFO: the books' recurrences ----
            locked = books["unlock_cnt"] < cfg.unlock_thresh
            acc = books["coarse_acc"]
            cf = books["coarse_frames"]
            settle = books["settle"]
            corrected = books["coarse_corrected"]
            coarse_est = books["coarse_foffset"]
            new_coarse = books["new_coarse"]

            # ---- closed-loop rotator update (block granular) ----
            fine_cf = fine.reshape(C, FP)
            fine_last = torch.zeros((C,), dtype=torch.float32, device=dev)
            for j in range(FP):
                fine_last = torch.where(d_valid[:, j], fine_cf[:, j],
                                        fine_last)
            have_fine = d_valid.any(dim=1)
            # a fired coarse estimate above the re-application floor takes
            # precedence even when corrected (see _coarse_reapply_min)
            coarse_due = new_coarse & (
                coarse_est.abs() > self._coarse_reapply_min)
            fine_ok = have_fine & (fine_last.abs() < self._coarse_reapply_min)
            adj = torch.where(coarse_due, coarse_est,
                              torch.where(corrected & fine_ok, fine_last, 0.0))
            adj = torch.where(settle <= 0, adj, 0.0)
            applied = adj != 0.0
            cum = state["cum_foffset"] + adj
            rot_inc = torch.where(applied, -cum * (2 * np.pi) / cfg.sps,
                                  state["rot_inc"])
            settle = torch.where(applied, self._settle0, settle)
            wipe = applied & ~corrected
            acc = torch.where(wipe[:, None, None], 0.0, acc)
            cf = torch.where(wipe, 0, cf)

        with span("outputs", dev):
            new_state = dict(
                state,
                fp_right=fp_right.clamp(max=self.N_SYM),
                pls=books["pls"],
                seq=state["seq"] + counts,
                coarse_acc=acc,
                coarse_frames=cf,
                coarse_foffset=coarse_est,
                coarse_corrected=corrected,
                cum_foffset=cum,
                settle=settle,
                rot_inc=rot_inc,
                unlock_cnt=books["unlock_cnt"],
            )
            new_state = {k: v.to(state[k].dtype) for k, v in new_state.items()}
            walked_metric = books["metric_sum"]
            stats = {
                "locked": locked,
                # frame start fell off the symbol ring: flag for re-acquisition
                "sym_lost": fp_right > self.N_SYM - 94,
                "metric": torch.where(
                    n_walked > 0, walked_metric / n_walked.clamp(min=1), 0.0),
                "n_walked": n_walked,
                "frames": counts.sum(dtype=torch.int32),
                "dummies": books["dummies"].sum(dtype=torch.int32),
                "rejected": books["rejected"].sum(dtype=torch.int32),
                "coarse_foffset": coarse_est,
                "coarse_corrected": corrected,
                "cum_foffset": cum,
                "fine_foffset": fine_last,
                "n0": n0.reshape(C, FP)[:, 0],
                "seq": new_state["seq"],
                "fp_right": fp_right.to(torch.int32),
                "overflow": overflow,
                "underflow": underflow,
            }
        return new_state, llr8, xf, meta, sels, stats

    def _append(self, state, si, llr8, xf8, meta, sel):
        """Append the lanes selected for PLS ``si`` to its queue, in lane
        order at the queue's fill: rows [fill, fill + B) take the selected
        lanes, then zeros (the JAX update of a compacted B-lane block).
        Returns (qllr, qxf, qmeta, fill) of that queue."""
        B = sel.shape[0]
        rank = torch.cumsum(sel.to(torch.int64), dim=0) - 1
        n_s = rank[-1] + 1
        urank = torch.cumsum((~sel).to(torch.int64), dim=0) - 1
        fill = state["qfill"][si].to(torch.int64)
        rows = fill + torch.where(sel, rank, n_s + urank)       # a permutation

        def put(q, x):
            return q.index_copy(0, rows, torch.where(sel[:, None], x, 0))

        return (put(state["qllr"][si], llr8), put(state["qxf"][si], xf8),
                put(state["qmeta"][si], meta), fill + n_s)

    def _fec(self, si, llrs, xq=None):
        """Decode frames of PLS ``si``: llrs (n, n_ldpc) int8 rows of its
        queue -> (kbytes (n, kb_max) uint8 scrambled, n_corr (n,) int32,
        iterations (0-d int32), refined SNR (n,) from the decoded bits
        against the symbol snapshots ``xq`` (n, 2 R_SUB) int8; 0 where BCH
        failed; None without ``xq``)."""
        fec, info = self._fecs[si], self._infos[si]
        n = llrs.shape[0]
        hard, _, iters, _ = self._ldpc[si](llrs[:, : fec.nldpc])
        corrected, n_corr = self._bch[si](hard[:, : fec.nbch],
                                          self._bch_sync_free)
        kbits = corrected[:, : fec.kbch].to(torch.int64).reshape(n, -1, 8)
        kbytes = (kbits * device_table(_BYTE_W, llrs.device)).sum(-1)
        kbytes = Fn.pad(kbytes.to(torch.uint8),
                        (0, self.kb_max - fec.kbch // 8))
        snr = None
        if xq is not None:
            const, rate = _MODCODS[info.modcod]
            xf = (xq.to(torch.float32) / self.XF_SCALE).reshape(
                n, self.R_SUB, 2)
            snr = _snr_refine_frames(xf, hard, const, rate, info.n_mod)
            snr = torch.where(n_corr >= 0, snr, 0.0)
        return kbytes, n_corr.to(torch.int32), iters.to(torch.int32), snr

    def _refine_n0(self, n0col, chan, snr):
        """Per-channel mean SNR over a batch's BCH-clean lanes -> refined
        N0 carry; a channel whose lanes in the batch all failed BCH drops
        its carry (0 = data-aided), so a stale N0 from before an SNR drop
        cannot keep scaling its LLRs."""
        C = self.n_channels
        oh = (chan[:, None].to(torch.int64)
              == torch.arange(C, device=chan.device)).to(torch.float32)
        ohc = oh * (snr > 0).to(torch.float32)[:, None]
        cnt = ohc.sum(0)
        mean = (ohc * snr[:, None]).sum(0) / cnt.clamp(min=1.0)
        n0col = torch.where(cnt > 0, 1.0 / mean.clamp(min=1e-9), n0col)
        return torch.where((oh.sum(0) > 0) & (cnt == 0), 0.0, n0col)

    def _slots(self, parts, shape, dtype):
        """DRAIN output slots: the decoded batches, then zeros."""
        z = torch.zeros(shape, dtype=dtype, device=self.device)
        return torch.stack(parts + [z] * (self.DRAIN - len(parts)))

    def step(self, state, iq):
        """One VCM stream step: (state, iq (C, n_in, 2)) -> (state',
        outputs, stats).

        ``outputs``: per key a list over the expected PLS set of ``kb``
        (DRAIN, B_fec, kb_max) uint8 scrambled BBFRAME bytes, ``meta``
        (DRAIN, B_fec, 2) int32 (channel, seq), ``n_corr`` (DRAIN, B_fec)
        int32 and ``fired`` (DRAIN,) bool, a host array since the host
        decides it; slots that did not fire hold zeros. ``stats`` adds
        ``ldpc_iters`` (per PLS, the most iterations of its batches) and
        ``n0_refined`` (C, S)."""
        st, llr, xf, meta, sels, stats = self._step_a(state, iq)
        st, outputs, stats_b = self._step_b(st, llr, xf, meta, sels)
        return st, outputs, dict(stats, **stats_b)

    @staticmethod
    def quantize_snapshots(xf):
        """Step A's symbol snapshots -> the int8 queue contents (rounded
        half to even, clipped to +-127); its LLRs arrive as int8."""
        return torch.round(xf).clamp(-127, 127).to(torch.int8)

    def _step_b(self, st, llr, xf, meta, sels):
        """Every PLS's queue append, pooled drain of full batches and
        refined-N0 update: the step's ``fec`` stage."""
        with span("fec", self.device):
            B_fec = self.B_fec
            xf8 = self.quantize_snapshots(xf)
            queues = [self._append(st, si, llr, xf8, meta, sels[si])
                      for si in range(self.S)]
            # the one readback of the step: how many full batches each
            # queue has
            fills = torch.stack([q[3] for q in queues]).cpu().numpy()
            outputs = {"kb": [], "meta": [], "n_corr": [], "fired": []}
            iters, n0cols, new_q = [], [], []
            for si, (ql, qx, qm, fill) in enumerate(queues):
                n_fire = min(self.DRAIN, int(fills[si]) // B_fec)
                n0col = st["n0_refined"][:, si]
                kb, md, nc, it = [], [], [], []
                for d in range(n_fire):
                    rows = slice(d * B_fec, (d + 1) * B_fec)
                    k_d, nc_d, it_d, snr = self._fec(si, ql[rows], qx[rows])
                    n0col = self._refine_n0(n0col, qm[rows, 0], snr)
                    kb.append(k_d)
                    md.append(qm[rows])
                    nc.append(nc_d)
                    it.append(it_d)
                taken = n_fire * B_fec
                if taken:
                    ql, qx, qm = (torch.cat([q[taken:], torch.zeros_like(
                        q[:taken])]) for q in (ql, qx, qm))
                new_q.append((ql, qx, qm, fill - taken))
                outputs["kb"].append(self._slots(kb, (B_fec, self.kb_max),
                                                 torch.uint8))
                outputs["meta"].append(self._slots(md, (B_fec, 2),
                                                   torch.int32))
                outputs["n_corr"].append(self._slots(nc, (B_fec,),
                                                     torch.int32))
                outputs["fired"].append(np.arange(self.DRAIN) < n_fire)
                iters.append(torch.stack(it).max() if it else torch.zeros(
                    (), dtype=torch.int32, device=self.device))
                n0cols.append(n0col)
            ql, qx, qm, fill = zip(*new_q)
            st = dict(
                st, qllr=torch.stack(ql), qxf=torch.stack(qx),
                qmeta=torch.stack(qm),
                qfill=torch.stack(fill).to(torch.int32),
                n0_refined=torch.stack(n0cols, dim=1),
            )
            return st, outputs, {"ldpc_iters": iters,
                                 "n0_refined": st["n0_refined"]}

    # ---------------- flush ----------------

    def flush(self, state):
        """Decode the queue remainders at the end of the stream (batches of
        up to B_fec frames). Returns (state' with empty queues, a list over
        S of [(kbytes, meta, n_corr) numpy arrays, ...])."""
        fills = state["qfill"].cpu().numpy()
        outs = []
        for si in range(self.S):
            taken = []
            for a in range(0, int(fills[si]), self.B_fec):
                b = min(int(fills[si]), a + self.B_fec)
                kb, nc, _, _ = self._fec(si, state["qllr"][si, a:b])
                taken.append((kb.cpu().numpy(),
                              state["qmeta"][si, a:b].cpu().numpy(),
                              nc.cpu().numpy()))
            outs.append(taken)
        state = dict(state, **{k: torch.zeros_like(state[k])
                               for k in ("qllr", "qmeta", "qxf", "qfill")})
        return state, outs

    # ---------------- priming ----------------

    def _acquire(self, iq):
        """Timing from scratch over (C, n_fe, 2) samples: (ffsync state,
        symbols (C, n_out, 2), consumed (C,), acquisition metric)."""
        C = self.n_channels
        ff2, syms, consumed = self.sync.step_batched(
            self.sync.init_state(C), iq, self.n_out)
        return ff2, syms, consumed, acq_metric(syms)

    def prime(self, iq_prefix: np.ndarray, strict: bool = True):
        """Acquire each channel from the first samples: dense CFO-robust
        timing metric, SOF peak, differential PLSC decode; the ring keeps
        every symbol from the SOF on and the chain carry points at it.
        Returns the device state; with ``strict=False`` a channel without
        a SOF keeps the zero state and is reported in ``self.prime_ok``."""
        cfg = self.cfg
        C, n_out, n_fe = self.n_channels, self.n_out, self._n_fe
        if iq_prefix.shape[0] != C:
            raise ValueError(f"expected {C} channels")
        if iq_prefix.shape[1] < n_fe:
            raise ValueError(f"prime needs >= {n_fe} samples per channel")
        iq = self.put_iq(cplx.from_np(iq_prefix[:, :n_fe]).astype(np.float32))
        iq, gain = prime_agc(iq, cfg)
        ff2, syms_d, consumed_d, metric_d = self._acquire(iq)
        syms = syms_d.cpu().numpy()
        consumed = consumed_d.cpu().numpy()
        metric = metric_d.cpu().numpy()
        rotated = iq.cpu().numpy()

        state = self.init_state_np()
        prime_ok = np.ones((C,), bool)
        sof = np.zeros((C,), np.int64)
        for c in range(C):
            win = metric[c, : self.L_max + 90]
            p = int(np.argmax(win))
            if win[p] < plsync.THRESHOLD_UNLOCKED or p < 89:
                if strict:
                    raise RuntimeError(
                        f"prime: no SOF on channel {c} (peak {win[p]:.1f})")
                prime_ok[c] = False
                sof[c] = 90
                continue
            sof[c] = p - 89
        hdrs = np.stack([
            np.zeros((90, 2), np.float32) if syms.shape[1] < sof[c] + 90
            else syms[c, sof[c]: sof[c] + 90] for c in range(C)
        ])
        pls, _ = plsync.plsc_decode_diff(torch.from_numpy(hdrs),
                                         self._search_mask.cpu())
        for c in np.flatnonzero(prime_ok):
            state["symbuf"][c, :, self.N_SYM - n_out:] = syms[c].T
            state["symfill"][c] = n_out
            state["fp_right"][c] = n_out - sof[c]
            state["pls"][c] = int(pls[c])
            tail = rotated[c, int(consumed[c]):n_fe]
            state["sbuf"][c, self.N_BUF - tail.shape[0]:] = tail
            state["sfill"][c] = tail.shape[0]
        state["ff_tau"] = ff2.tau.cpu().numpy()
        state["ff_rate"] = ff2.rate.cpu().numpy()
        state["ff_init"] = ff2.initialized.cpu().numpy()
        state["agc_gain"] = gain.cpu().numpy()
        self.prime_ok = prime_ok
        return vcm_state_from_numpy(state, self.device)

    # ---------------- re-acquisition (device-side) ----------------

    def reacquire(self, state, iq_tail, mask):
        """Re-acquire the channels flagged in ``mask`` ((C,) bool tensor)
        from the latest ``n_fe`` raw samples (``iq_tail`` (C, n_fe, 2) on
        the device): fresh timing, dense metric, differential PLSC decode,
        spliced into the carried state with masked merges. CFO knowledge
        survives; alignment, the chain carry, the coarse accumulators and
        the refined N0 reset. Queues and seq counters are untouched.
        Returns (state', ok)."""
        cfg = self.cfg
        C, n_out, n_fe = self.n_channels, self.n_out, self._n_fe
        gain = state["agc_gain"]
        fe = frontend(iq_tail, gain, torch.zeros_like(gain), state["rot_inc"],
                      "given" if cfg.agc else "off")
        rot, phase = fe["out"], fe["phase"]
        ff2, syms, consumed, metric = self._acquire(rot)
        win = metric[:, : self.L_max + 90]
        p = win.argmax(dim=1)
        found = (win.gather(1, p[:, None])[:, 0] >= plsync.THRESHOLD_UNLOCKED
                 ) & (p >= 89)
        sof = (p - 89).clamp(0, n_out - 90)
        hdr = _window(syms, sof, 90)
        pls, _ = plsync.plsc_decode_diff(hdr, enabled_mask=self._search_mask)
        pad = torch.zeros((C, self.N_SYM - n_out, 2), dtype=torch.float32,
                          device=rot.device)
        symbuf = torch.cat([pad, syms], dim=1)
        tail_pad = torch.zeros((C, max(self.N_BUF - n_fe, 0), 2),
                               dtype=torch.float32, device=rot.device)
        sbuf = torch.cat([tail_pad, rot], dim=1)[:, -self.N_BUF:]
        ok = mask & found

        def mk(new, old):
            return torch.where(ok.reshape((C,) + (1,) * (old.ndim - 1)),
                               new.to(old.dtype), old)

        zc = torch.zeros((C,), dtype=torch.int32, device=rot.device)
        new_state = dict(
            state,
            sbuf=mk(sbuf, state["sbuf"]),
            sfill=mk(n_fe - consumed, state["sfill"]),
            ff_tau=mk(ff2.tau, state["ff_tau"]),
            ff_rate=mk(ff2.rate, state["ff_rate"]),
            ff_init=mk(ff2.initialized, state["ff_init"]),
            rot_phase=mk(phase, state["rot_phase"]),
            symbuf=mk(symbuf, state["symbuf"]),
            symfill=mk(torch.full_like(zc, n_out), state["symfill"]),
            fp_right=mk(n_out - sof, state["fp_right"]),
            pls=mk(pls, state["pls"]),
            coarse_acc=mk(torch.zeros_like(state["coarse_acc"]),
                          state["coarse_acc"]),
            coarse_frames=mk(zc, state["coarse_frames"]),
            unlock_cnt=mk(zc, state["unlock_cnt"]),
            # the refined N0 is stale after re-acquisition: data-aided
            # until the next decoded batch
            n0_refined=mk(torch.zeros_like(state["n0_refined"]),
                          state["n0_refined"]),
        )
        return new_state, ok


class VCMStreamEngine:
    """Product host receiver around ``VCMStreamReceiver``: chunked input,
    soft priming, automatic re-acquisition and per-channel seq-ordered TS
    stitching, with the ``receive()/get_stats()`` surface of the JAX
    ``VCMStreamEngine``. The TS stitch takes device CRC-8 validity maps
    (``ops.crc8_dev.packet_validity``) for each decoded batch; its bytes are
    those of the JAX engine's host CRC stitch."""

    def __init__(self, cfg, n_channels: int = 1, frames_per_step: int = 2,
                 fec_lanes: int = None, device=None):
        self.cfg = cfg
        self.sr = sr = VCMStreamReceiver(
            cfg, n_channels=n_channels, frames_per_step=frames_per_step,
            fec_lanes=fec_lanes, device=device,
        )
        self.n_channels = C = n_channels
        self.stats = RxStats()
        self.bb_parsers = [BBFrameParser() for _ in range(C)]
        self.bb_parser = self.bb_parsers[0]
        self._buf = np.empty((C, 0), np.complex64)
        self._primed = False
        self.state = None
        self._was_locked = np.zeros((C,), bool)
        # per-channel seq-ordered delivery
        self._reorder = [dict() for _ in range(C)]
        self._next_seq = np.zeros((C,), np.int64)
        self._blocked = np.zeros((C,), np.int32)
        self.gaps_skipped = 0
        # re-acquisition from a rolling history of raw blocks
        self._blk_hist = []
        self._nblk = int(np.ceil(sr._n_fe / sr.n_in)) + 1
        self.need = np.zeros((C,), bool)
        self.reacquired = 0
        self._per_pls = [{"fec_frames": 0, "fec_errors": 0}
                         for _ in range(sr.S)]
        self._n0_ref = np.zeros((C, sr.S), np.float32)
        self._scr = [torch.as_tensor(s, device=sr.device)
                     for s in sr.bb_scramble]

    def get_stats(self, sym_rate: float = None) -> dict:
        """Reference-shaped statistics plus per-PLS sections: refined SNR,
        frame and error counters per expected PLS."""
        base = get_stats(self, sym_rate)
        per_plsync, per_fec = {}, {}
        for si, pls in enumerate(self.sr.pls_set):
            st = self._per_pls[si]
            if st["fec_frames"] == 0:
                continue
            const, rate = _MODCODS[self.sr._infos[si].modcod]
            name = f"{const.lower()}{rate}"
            # refined N0 averaged over the channels that carry it
            col = self._n0_ref[:, si]
            n0 = float(col[col > 0].mean()) if (col > 0).any() else 0.0
            per_plsync[pls] = {"modcod": name, "frames": st["fec_frames"]}
            per_fec[pls] = {
                "modcod": name,
                "frames": st["fec_frames"],
                "errors": st["fec_errors"],
                "snr": float(10 * np.log10(1.0 / n0)) if n0 > 0 else None,
            }
        base["plsync"]["per_pls"] = per_plsync
        base["fec"]["per_pls"] = per_fec
        return base

    # ---- output handling ----

    def _ingest_batch(self, si, kb, meta, ncorr):
        """One decoded batch of PLS ``si``: kb (n, kb_max) uint8 scrambled
        bytes (a tensor on any device, or numpy), meta (n, 2), ncorr (n,)
        numpy. Counts it and files each frame, with its validity maps,
        under (channel, seq)."""
        s = self.stats
        n = ncorr.shape[0]
        errs = int(np.sum(ncorr < 0))
        s.ldpc_frames += n
        s.bch_frames += n
        s.bch_frame_errors += errs
        s.bch_corrections += int(np.sum(np.maximum(ncorr, 0)))
        self._per_pls[si]["fec_frames"] += n
        self._per_pls[si]["fec_errors"] += errs
        nbytes = self.sr._fecs[si].kbch // 8
        kb = torch.as_tensor(kb, device=self.sr.device)[:, :nbytes]
        frames = kb ^ self._scr[si]
        ts_ok, hdr_ok = packet_validity(frames)
        frames, ts_ok, hdr_ok = (t.cpu().numpy()
                                 for t in (frames, ts_ok, hdr_ok))
        for i in range(n):
            c, seq = int(meta[i, 0]), int(meta[i, 1])
            self._reorder[c][seq] = (frames[i], ts_ok[i], bool(hdr_ok[i]))

    def _ingest(self, outputs):
        for si in range(self.sr.S):
            fired = np.flatnonzero(outputs["fired"][si])
            if fired.size == 0:
                continue
            sel = slice(0, fired.size)      # fired slots come first
            kb = outputs["kb"][si][sel].flatten(0, 1)
            meta = outputs["meta"][si][sel].flatten(0, 1).cpu().numpy()
            nc = outputs["n_corr"][si][sel].flatten(0, 1).cpu().numpy()
            self._ingest_batch(si, kb, meta, nc)

    def _deliver(self):
        """Pop contiguous seq runs per channel into the BB parsers."""
        out = [[] for _ in range(self.n_channels)]
        for c in range(self.n_channels):
            buf = self._reorder[c]
            progressed = True
            while progressed:
                progressed = False
                nxt = int(self._next_seq[c])
                if nxt in buf:
                    frame, ok, hdr_ok = buf.pop(nxt)
                    out[c].append(self.bb_parsers[c].push(frame, ok, hdr_ok))
                    self._next_seq[c] += 1
                    self._blocked[c] = 0
                    progressed = True
                elif buf and self._blocked[c] >= GAP_SKIP_STEPS:
                    # frames lost to a re-acquisition (or rejected): skip
                    # forward; the BB parser re-syncs via SYNCD
                    self._next_seq[c] = min(buf)
                    self.gaps_skipped += 1
                    progressed = True
            if buf:
                self._blocked[c] += 1
        return out

    def _update_stats(self, stats):
        s = self.stats
        locked = stats["locked"].cpu().numpy()
        now_locked = bool(locked.all())
        if now_locked and not s.locked:
            s.lock_cnt += 1
            s.lock_time = time.time()
        if (~locked & self._was_locked).any():
            s.unlock_cnt += int((~locked & self._was_locked).sum())
        self._was_locked = locked
        s.locked = now_locked
        s.frame_cnt += int(stats["frames"])
        s.sof_cnt += int(stats["n_walked"].sum())
        s.dummy_cnt += int(stats["dummies"])
        s.rejected_cnt += int(stats["rejected"])
        s.coarse_foffset = float(stats["coarse_foffset"][0])
        s.fine_foffset = float(stats["fine_foffset"][0])
        s.cum_freq_offset = float(stats["cum_foffset"][0])
        s.coarse_corrected = bool(stats["coarse_corrected"].all())
        n0 = float(stats["n0"][0])
        if n0 > 0:
            s.snr_db = float(10 * np.log10(1.0 / max(n0, 1e-12)))
        s.ldpc_total_iters += int(torch.stack(stats["ldpc_iters"]).max())
        self._n0_ref = stats["n0_refined"].cpu().numpy()

    # ---- the host loop ----

    def receive(self, iq: np.ndarray, flush: bool = True):
        """Process IQ samples; returns TS bytes (a flat array for one
        channel, a list of arrays for several). Host spans as
        ``StreamEngine.receive``'s, the stitch on this thread."""
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
            self.state = sr.prime(self._buf[:, : sr._n_fe], strict=False)
            self.need = ~sr.prime_ok
            self._buf = self._buf[:, sr._n_fe:]
            self._primed = True

        while self._primed and self._buf.shape[1] >= sr.n_in:
            with span("engine.reblock"):
                blk = sr.put_iq(
                    cplx.from_np(self._buf[:, : sr.n_in]).astype(np.float32))
                self._buf = self._buf[:, sr.n_in:]
            self._blk_hist.append(blk)
            if len(self._blk_hist) > self._nblk:
                self._blk_hist.pop(0)
            self.state, outputs, stats = sr.step(self.state, blk)
            with span("engine.stats"):
                self._update_stats(stats)
            with span("engine.stitch"):
                self._ingest(outputs)
                for c, parts in enumerate(self._deliver()):
                    ts[c].extend(parts)
            with span("session.readback"):
                flags = torch.stack([~stats["locked"], stats["underflow"],
                                     stats["overflow"], stats["sym_lost"]])
                self.need |= flags.cpu().numpy().any(axis=0)
            have = sum(b.shape[1] for b in self._blk_hist)
            if self.need.any() and have >= sr._n_fe:
                tail = torch.cat(self._blk_hist, dim=1)[:, -sr._n_fe:]
                self.state, ok = sr.reacquire(
                    self.state, tail, torch.as_tensor(self.need,
                                                      device=sr.device))
                ok = ok.cpu().numpy()
                self.reacquired += int(ok.sum())
                self.need &= ~ok

        if flush and self._primed:
            self.state, rem = sr.flush(self.state)
            for si, taken in enumerate(rem):
                for kb, md, nc in taken:
                    self._ingest_batch(si, kb, md, nc)
            # final delivery: skip any unfilled gaps
            self._blocked[:] = GAP_SKIP_STEPS
            for c, parts in enumerate(self._deliver()):
                ts[c].extend(parts)
        out = [np.concatenate(t) if t else np.empty(0, np.uint8) for t in ts]
        return out[0] if self.n_channels == 1 else out
