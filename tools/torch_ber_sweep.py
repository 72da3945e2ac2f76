#!/usr/bin/env python3
"""Post-LDPC/BCH BER/FER and PLSC decode FER over an Es/N0 sweep, on the
PyTorch/CUDA port.

The counterpart of ``tools/ber_sweep.py`` for ``dvbs2rx_tpu_torch``: the
same options, the same draws from ``np.random.default_rng(0)`` in the same
order (per batch the info bits, then each frame's noise in turn; for
``--plsc`` per chunk of 4,096 the PLS words, then the noise) and the same
output, so that one seed, batch and set of points give counts comparable
one for one with the JAX tool's.

Runs the demap -> LDPC -> BCH chain over encoded codewords (the port's
``DeviceEncoder``, the host's interleaver, mapper and AWGN, ``demap``, the
decoders of ``rx.receiver.get_ldpc_decoder`` and ``get_bch_decoder``) at
each Es/N0 point and reports BER before decoding, after LDPC and after
BCH, and FER. BCH decodes in the decoder's default form: on the card the
locator kernel runs on every batch and the Chien kernel on every batch
with an error, so near the waterfall both see real post-LDPC residual
errors, frames beyond t included. ``--plsc`` sweeps the PL signaling
decoder instead: random PLS words RM(1,6)-encoded, scrambled, pi/2-BPSK
mapped into PLHEADERs, AWGN-impaired, and decoded in all three modes
(coherent-soft, coherent-hard, differential).

Runs on the card; ``--cpu`` runs on the CPU (``device="cpu"``). Without a
card and without ``--cpu`` it stops with an error: it never moves to the
CPU on its own.

Usage:
    python tools/torch_ber_sweep.py --modcod qpsk1/2 --frame-size normal \\
        --esn0 1.6 1.8 --frames 128 --batch 16 [--json] [--cpu]
    python tools/torch_ber_sweep.py --plsc --esn0 -6.61 --frames 60000 \\
        [--json] [--cpu]

``fec_sweep`` and ``plsc_sweep`` return the result dicts that ``--json``
prints; ``fec_sweep``'s ``on_bch`` sees every batch's BCH input and output.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

PLSC_CHUNK = 4096       # PLHEADERs per decode call, as the JAX tool


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--modcod", default="qpsk1/2")
    ap.add_argument("--frame-size", default="short")
    ap.add_argument("--esn0", type=float, nargs="+",
                    default=[0.0, 0.5, 1.0, 1.5, 2.0])
    ap.add_argument("--frames", type=int, default=32, help="frames per point")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=25)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--plsc", action="store_true",
                    help="sweep PLSC decode FER instead of LDPC/BCH BER")
    return ap.parse_args(argv)


def fec_sweep(modcod, frame_size, esn0, frames, batch=16, iterations=25,
              device=None, on_bch=None):
    """The demap -> LDPC -> BCH sweep: {"modcod", "frame_size", "points":
    [{"esn0_db", "raw_ber", "post_ldpc_ber", "post_bch_ber", "fer",
    "frames"}, ...]}. ``on_bch(bits, corrected, n_corr)``, if given, is
    called after each batch's BCH decode with its input (B, nbch) hard bits
    and its outputs."""
    import torch

    from dvbs2rx_tpu_torch.ops import cplx
    from dvbs2rx_tpu_torch.ops.demap import demap
    from dvbs2rx_tpu_torch.ops.encode import get_device_encoder
    from dvbs2rx_tpu_torch.rx.receiver import (
        get_bch_decoder,
        get_ldpc_decoder,
    )
    from dvbs2rx_tpu_torch.spec.constellations import BITS_PER_SYMBOL, map_bits
    from dvbs2rx_tpu_torch.spec.fec_params import (
        DVBS2_MODCODS,
        MODCOD_NUMBERS,
        get_fec_info,
    )
    from dvbs2rx_tpu_torch.spec.interleaver import interleave
    from dvbs2rx_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    const, rate = DVBS2_MODCODS[MODCOD_NUMBERS[modcod.lower()]]
    fec = get_fec_info(frame_size, rate)
    ldpc = get_ldpc_decoder(fec.ldpc_table, iterations, device=dev)
    bch = get_bch_decoder(fec.framesize, fec.t, fec.nbch, fec.kbch,
                          device=dev)
    enc = get_device_encoder(fec.framesize, rate, device=dev)
    n_mod = BITS_PER_SYMBOL[const]

    rng = np.random.default_rng(0)
    results = []
    for esn0_db in esn0:
        n0 = 1.0 / 10 ** (esn0_db / 10)
        sigma = np.sqrt(n0 / 2)
        raw_errs = ldpc_errs = bch_errs = fer = 0
        total_info = total_coded = done = 0
        while done < frames:
            B = min(batch, frames - done)
            info_bits = rng.integers(0, 2, (B, fec.kbch), dtype=np.uint8)
            cws_dev = enc(info_bits.T.copy()).t()              # (B, nldpc)
            cws = cws_dev.cpu().numpy()
            noisy = np.empty((B, fec.nldpc // n_mod), dtype=np.complex64)
            for i in range(B):
                bits = interleave(cws[i], const, rate)
                syms = map_bits(bits, const, rate).astype(np.complex64)
                noise = rng.normal(0, sigma, (syms.size, 2)).astype(
                    np.float32)
                noisy[i] = syms + noise[:, 0] + 1j * noise[:, 1]
            llrs = demap(torch.as_tensor(cplx.from_np(noisy), device=dev),
                         torch.full((B,), np.float32(n0), device=dev),
                         const, rate)
            raw_errs += int(((llrs < 0) != cws_dev.bool()).sum())
            total_coded += B * fec.nldpc
            hard = ldpc(llrs)[0]
            ldpc_errs += int((hard[:, : fec.kbch]
                              != cws_dev[:, : fec.kbch]).sum())
            bch_in = hard[:, : fec.nbch]
            corrected, n_corr = bch(bch_in)
            if on_bch is not None:
                on_bch(bch_in, corrected, n_corr)
            info = torch.as_tensor(info_bits, device=dev)
            errs = (corrected[:, : fec.kbch] != info).sum(1)
            bch_errs += int(errs.sum())
            fer += int((errs > 0).sum())
            total_info += B * fec.kbch
            done += B
        results.append({
            "esn0_db": esn0_db,
            "raw_ber": raw_errs / total_coded,
            "post_ldpc_ber": ldpc_errs / total_info,
            "post_bch_ber": bch_errs / total_info,
            "fer": fer / frames,
            "frames": frames,
        })
    return {"modcod": modcod, "frame_size": frame_size, "points": results}


def plsc_sweep(esn0, frames, device=None):
    """PLSC decode FER against Es/N0 for the three decode modes: {"mode":
    "plsc", "points": [{"esn0_db", "frames", "fer_soft", "fer_hard",
    "fer_diff"}, ...]}."""
    import torch

    from dvbs2rx_tpu_torch.ops import cplx, plsync
    from dvbs2rx_tpu_torch.spec import pi2_bpsk, pl_defs, reed_muller
    from dvbs2rx_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    # all 128 PLS codewords searchable (no a-priori restriction), like the
    # reference PLSC benchmark
    headers = np.stack([
        pi2_bpsk.map_bpsk(np.concatenate([
            pl_defs.SOF_BITS,
            reed_muller.encode(pls) ^ pl_defs.PLSC_SCRAMBLER_BITS,
        ]))
        for pls in range(128)
    ])                                                   # (128, 90) complex
    decoders = {
        "soft": plsync.plsc_decode_soft,
        "hard": plsync.plsc_decode_hard,
        "diff": plsync.plsc_decode_diff,
    }
    rng = np.random.default_rng(0)
    results = []
    for esn0_db in esn0:
        sigma = np.sqrt(1.0 / 10 ** (esn0_db / 10) / 2)
        errs = dict.fromkeys(decoders, 0)
        done = 0
        while done < frames:
            n = min(PLSC_CHUNK, frames - done)
            pls_true = rng.integers(0, 128, n)
            noise = rng.normal(0, sigma, (n, 90, 2))
            noisy = (headers[pls_true] + noise[..., 0]
                     + 1j * noise[..., 1]).astype(np.complex64)
            x = torch.as_tensor(cplx.from_np(noisy), device=dev)
            want = torch.as_tensor(pls_true, device=dev)
            for k, dec in decoders.items():
                errs[k] += int((dec(x)[0] != want).sum())
            done += n
        point = {"esn0_db": esn0_db, "frames": frames}
        point.update({f"fer_{k}": errs[k] / frames for k in decoders})
        results.append(point)
    return {"mode": "plsc", "points": results}


def main(argv=None):
    """What ``tools/ber_sweep.py`` prints: one line a point, or with
    ``--json`` the result dict."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.plsc:
        out = plsc_sweep(args.esn0, args.frames, device)
    else:
        out = fec_sweep(args.modcod, args.frame_size, args.esn0, args.frames,
                        args.batch, args.iterations, device)
    if args.json:
        print(json.dumps(out))
        return 0
    for r in out["points"]:
        if args.plsc:
            print(f"Es/N0 {r['esn0_db']:5.2f} dB | "
                  + " | ".join(f"{k} FER {r[f'fer_{k}']:.3e}"
                               for k in ("soft", "hard", "diff")))
        else:
            print(f"Es/N0 {r['esn0_db']:5.2f} dB | raw BER {r['raw_ber']:.3e} | "
                  f"post-LDPC {r['post_ldpc_ber']:.3e} | "
                  f"post-BCH {r['post_bch_ber']:.3e} | FER {r['fer']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
