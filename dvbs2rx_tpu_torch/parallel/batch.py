"""Per-lane PLFRAME processing over a (channel x frame) lane batch.

Port of ``make_lane_fn`` from ``dvbs2rx_tpu/parallel/batch.py``. The JAX
closure processes one frame and is vmapped over lanes; here the lane axis
is written out. At the boundary it stays trailing, as the JAX vmap's
``in_axes=-1`` / ``out_axes`` put it: headers (91, 2, B), payloads
(Lp, 2, B), LLRs out (N, B). Inside, lanes lead, so the batched ``plsync``
and ``demap`` functions apply directly. ``BatchedPipeline`` and the mesh
helpers come later.
"""

import torch

from ..ops import cplx, plsync
from ..ops.demap import demap, estimate_snr_generic, estimate_snr_qpsk


def make_lane_fn(cfg, descr):
    """Lane-batched PLFRAME processing closure.

    ``lane(hdr_ext, nxt_ext, payload, coarse_corrected, n0_override)``:
    hdr_ext/nxt_ext (91, 2, B) extended header pairs, payload (Lp, 2, B),
    coarse_corrected (B,) bool, n0_override (B,) float (> 0 demaps with the
    post-decoder refined N0). ``descr`` is the (Lp, 2) planar PL
    descrambling sequence on the lanes' device. Returns a dict with
    metric (B, 2), autocorr (B, 89, 2), fine (B,), n0 (B,), llrs (N, B)
    float32 before quantisation, xfec (B, R, 2).
    """
    info = cfg.pls_info

    def lane(hdr_ext, nxt_ext, payload, coarse_corrected, n0_override):
        exts = torch.stack([hdr_ext, nxt_ext]).permute(3, 0, 1, 2)  # (B,2,91,2)
        headers = exts[:, :, 1:]                                    # (B,2,90,2)
        d = cplx.conj_mul(exts[:, :, 1:], exts[:, :, :-1])
        metric = plsync.frame_metric(d[:, :, 1:])                   # (B, 2)
        B = exts.shape[0]
        pls2 = torch.full((B, 2), cfg.pls, dtype=torch.int64,
                          device=exts.device)
        r = plsync.coarse_autocorr(headers[:, 0], pls2[:, 0], full=True)
        hdr_phase = plsync.plheader_phase(headers, pls2)            # (B, 2)
        pay = payload.permute(2, 0, 1)                              # (B,Lp,2)
        payload_d = cplx.cmul(pay, descr)
        if info.has_pilots:
            fine = plsync.fine_foffset_pilot_mode(
                headers[:, 0], payload_d, pls2[:, 0], info.n_pilots
            )
            pil_ph = plsync.pilot_phases(payload_d, info.n_pilots)
            fine_ff = torch.where(coarse_corrected, fine, 0.0)
            xfec = plsync.correct_payload_pilots(
                payload_d, hdr_phase[:, 0], pil_ph, fine_ff,
                info.n_slots, info.n_pilots,
            )
        else:
            fine = plsync.fine_foffset_pilotless(
                hdr_phase[:, 0], hdr_phase[:, 1], info.plframe_len
            )
            fine_ff = torch.where(coarse_corrected, fine, 0.0)
            xfec = plsync.correct_payload_pilotless(
                payload_d, hdr_phase[:, 0], fine_ff
            )
        if cfg.constellation == "QPSK":
            snr = estimate_snr_qpsk(xfec)
        else:
            snr = estimate_snr_generic(xfec, cfg.constellation, cfg.rate)
        n0 = 1.0 / snr.clamp(min=1e-9)
        n0_demap = torch.where(n0_override > 0, n0_override, n0)
        llr = demap(xfec, n0_demap, cfg.constellation, cfg.rate,
                    quantize=False)                                 # (B, N)
        return {"metric": metric, "autocorr": r, "fine": fine, "n0": n0,
                "llrs": llr.t(), "xfec": xfec}

    return lane
