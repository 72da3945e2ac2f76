"""Layered min-sum LDPC decoder in plain PyTorch.

Port of the roll-based decoder ``dvbs2rx_tpu/ops/ldpc.py`` with its check
rules (offset-min-sum with beta = 1, the default; min-sum, beta = 0; and
min-sum-c, the two-input min with a correction term) and its message store
rules (normal; self-corrected, which zeroes a message whose sign flipped).
It is the plain version of the CUDA kernel in ``ldpc_cuda.py``, which
implements offset-min-sum with the normal update only: CPU tensors take this
decoder, and so does every other (algo, update) on any device, as the JAX
package sends those rules to its XLA path.

The frame state is one flat (N, B) column per frame in the kernel's
shared-memory layout: data block ``b`` at rows ``b*360 .. b*360+359``,
parity row ``p[i][m]`` (LLR index ``K + m*q + i``) at row ``K + i*360 + m``.
A layer's cyclic rolls become one precomputed (E, 360) index into that
state, so a layer reads all its edge values with one gather, before any
write, and writes the deltas back in edge order: one scatter per run of
edges whose blocks are distinct (a block named twice in a layer starts a
new run, because saturating deltas do not commute).

Per-lane freeze, as in the JAX decoder: a frame whose parity check passed
takes no further deltas, so every frame's result is independent of its
batch. Outputs match the JAX decoder bit for bit: hard bits, final LLRs,
the batch iteration count and per-frame convergence. ``decode_frames``
also counts the iterations each frame ran (those it entered unconverged,
as the CUDA kernel counts them); the batch count is their maximum.

Compressed check messages (the CUDA kernel's on-chip layout, which assumes
the default rule's +-32 clamp; min-sum-c stores int8 messages). The stored
message of edge ``c`` is ``clip(+-excl_c, -32, 31)`` with ``excl_c = min1``
for the first edge ``idx0`` that reaches the layer row's minimum magnitude
``min0`` and ``min0`` for every other edge (a tie at ``min0`` makes
``min1 == min0``, so both rules agree), signed by the XOR of the other
edges' signs. So one word per (layer, check row) holds the whole row:

    bits 0-5    min(min0, 32)
    bits 6-11   min(min1, 32)
    next IB     idx0                  (IB = 3, 4, 5 bits)
    next E      output sign of each edge, edge c at bit c

for codes of at most KE = 8, 16, 32 edges per check (3, 4 and 8 bytes a
word; ``msg_layout``). ``pack_layer_msgs`` / ``unpack_layer_msgs`` are that
layout in plain PyTorch; unpacking gives back the stored messages exactly.
Iteration 0 and the layer-0 dead edge keep their rules: message 0.

LLR convention: positive = bit 0.
"""

import numpy as np
import torch

from ..spec.ldpc_tables import LDPCCode
from ..utils.runtime import resolve_device

M = 360
MSG_CLAMP_LO = -32
MSG_CLAMP_HI = 31
BETA = 1


def layer_edges(code: LDPCCode):
    """Per-layer data-edge lists [(block, shift), ...] in table order."""
    lay = code.layers
    edges = []
    for i in range(code.q):
        edges.append([
            (int(lay["block"][i, c]), int(lay["shift"][i, c] % code.M))
            for c in range(lay["max_cnt"]) if lay["block"][i, c] >= 0
        ])
    return edges


def edge_rows(code: LDPCCode, i: int, edges) -> np.ndarray:
    """(E, 360) state rows read by layer ``i``'s edges at each check row:
    the data edges, then own parity, then previous parity (layer 0's row 0
    has no previous parity edge; its entry is masked by the callers)."""
    K, q = code.K, code.q
    r = np.arange(M)
    rows = [b * M + (r - s) % M for b, s in edges[i]]
    rows.append(K + i * M + r)
    if i > 0:
        rows.append(K + (i - 1) * M + r)
    else:
        rows.append(K + (q - 1) * M + (r - 1) % M)
    return np.stack(rows).astype(np.int64)


def write_runs(edges_i):
    """Split a layer's edge order into runs of distinct blocks: [(a, b)].

    A run starts at every data edge whose block an earlier edge of the layer
    already names (the CUDA kernel places a barrier there). The two parity
    edges touch parity rows only and close the last run."""
    seen, starts = set(), [0]
    for c, (b, _) in enumerate(edges_i):
        if b in seen and c > 0:
            starts.append(c)
        seen.add(b)
    E = len(edges_i) + 2
    ends = starts[1:] + [E]
    return list(zip(starts, ends))


ALGOS = ("offset-min-sum", "min-sum", "min-sum-c")
UPDATES = ("normal", "self-corrected")


def magnitudes(inp, beta=BETA):
    """Offset magnitudes ``max(min(|inp|, 127) - beta, 0)`` of check-node
    inputs."""
    return (inp.abs().clamp(max=127) - beta).clamp(min=0)


def check_node(inp, beta=BETA):
    """(Offset-)min-sum check-node outputs, unclamped: inputs (E, ...) ->
    (E, ...), excluding each edge's own input (first-min rule, min1 with
    multiplicity)."""
    mags = magnitudes(inp, beta)
    two = torch.topk(mags, 2, dim=0, largest=False).values
    min0, min1 = two[0], two[1]
    excl = torch.where(mags == min0, min1, min0)
    neg = (inp < 0).to(torch.int32)
    excl_sign = (neg.sum(dim=0, keepdim=True) & 1) ^ neg
    return torch.where(excl_sign == 1, -excl, excl)


def minc(a, b, factor=2):
    """Two-input min with the additive correction factor (reference
    ``algorithms.hh`` MinSumCAlgorithm::minc, FACTOR = 2): the magnitude
    min with the product sign (0 if either input is 0), nudged by
    +-factor/2 where |a + b| or |a - b| is small."""
    m = torch.minimum(a.abs(), b.abs())
    x = torch.sign(a) * torch.sign(b) * m
    apb = (a + b).abs()
    amb = (a - b).abs()
    half = factor // 2
    pc = (2 * factor > apb) & (amb > 2 * apb)
    nc = (2 * factor > amb) & (apb > 2 * amb)
    x = torch.where(pc, x + half, x)
    return torch.where(nc, x - half, x)


def minc_exclusive(inp):
    """Exclusive ``minc`` reduce over the edge axis in the reference's
    prefix/suffix order (``exclusive_reduce.hh:20-34``): prefixes combine
    left to right from the head, suffixes right to left from the tail, and
    out[i] = minc(prefix, suffix). ``minc`` is not associative, so the order
    is part of the result. inp (E, ...) with E >= 3."""
    E = inp.shape[0]
    outs = [None] * E
    pres = [None] * E
    pre = inp[0]
    for i in range(1, E - 1):
        pres[i] = pre
        pre = minc(pre, inp[i])
    outs[E - 1] = pre
    suf = inp[E - 1]
    for i in range(E - 2, 0, -1):
        outs[i] = minc(pres[i], suf)
        suf = minc(suf, inp[i])
    outs[0] = suf
    return torch.stack(outs)


def msg_layout(max_deg: int):
    """(KE, IB, word bytes) of the compressed message word for a code whose
    checks have at most ``max_deg`` edges (the kernel's template bucket)."""
    for ke, ib, nbytes in ((8, 3, 3), (16, 4, 4), (32, 5, 8)):
        if max_deg <= ke:
            return ke, ib, nbytes
    raise ValueError(f"{max_deg} edges per check: at most 32 supported")


def pack_layer_msgs(inp, max_deg=None):
    """Check-node inputs (E, ...) of one layer (clamped to int8, the dead
    edge's input 127) -> (...) int64 words in the kernel's layout."""
    E = inp.shape[0]
    _, ib, _ = msg_layout(max_deg or E)
    mags = magnitudes(inp).to(torch.int64)
    min0 = mags.min(dim=0).values
    idx0 = (mags == min0).to(torch.int64).argmax(dim=0)     # first min
    min1 = mags.scatter(0, idx0[None], 1 << 16).min(dim=0).values
    neg = (inp < 0).to(torch.int64)
    sign = (neg.sum(dim=0) & 1) ^ neg                     # (E, ...)
    c = torch.arange(E, device=inp.device).reshape((E,) + (1,) * idx0.dim())
    signs = (sign << c).sum(dim=0)
    return (min0.clamp(max=32) | (min1.clamp(max=32) << 6) | (idx0 << 12)
            | (signs << (12 + ib)))


def unpack_layer_msgs(words, E: int, dead=None, max_deg=None):
    """Words (...) -> stored messages (E, ...) int32, ``clip(out, -32,
    31)``. ``dead`` (bool, broadcastable to ``words``) marks rows whose last
    edge is the layer-0 dead edge: its message is 0."""
    _, ib, _ = msg_layout(max_deg or E)
    w = words.to(torch.int64)
    m0, m1 = w & 63, (w >> 6) & 63
    idx0 = (w >> 12) & ((1 << ib) - 1)
    c = torch.arange(E, device=w.device).reshape((E,) + (1,) * w.dim())
    neg = (w[None] >> (12 + ib + c)) & 1
    excl = torch.where(c == idx0[None], m1[None], m0[None])
    msg = torch.where(neg == 1, -excl, excl).clamp(MSG_CLAMP_LO, MSG_CLAMP_HI)
    if dead is not None:
        msg[E - 1] = torch.where(dead, 0, msg[E - 1])
    return msg.to(torch.int32)


def to_state(llrsT, code: LDPCCode):
    """Lane-major (N, B) LLRs -> flat (N, B) state (parity rows regrouped)."""
    K, q = code.K, code.q
    B = llrsT.shape[1]
    par = llrsT[K:].reshape(M, q, B).transpose(0, 1).reshape(q * M, B)
    return torch.cat([llrsT[:K], par], dim=0)


def from_state(st, code: LDPCCode):
    """Inverse of ``to_state``."""
    K, q = code.K, code.q
    B = st.shape[1]
    par = st[K:].reshape(q, M, B).transpose(0, 1).reshape(M * q, B)
    return torch.cat([st[:K], par], dim=0)


class LDPCDecoder:
    """Batched layered decoder for one code table and one (algo, update)
    pair (``ALGOS``, ``UPDATES``).

    ``__call__`` takes (B, N) int8 LLRs, ``decode_lane_major`` takes (N, B);
    both return (hard bits uint8, final LLRs int8, iterations int32 scalar,
    converged (B,) bool) in the layout they were given. ``decode_frames``
    is ``decode_lane_major`` with the iterations of each frame, (B,) int32,
    in place of the scalar.
    """

    def __init__(self, code: LDPCCode, max_trials: int = 25, device=None,
                 algo: str = "offset-min-sum", update: str = "normal"):
        if algo not in ALGOS:
            raise ValueError(f"unknown LDPC algorithm {algo!r}")
        if update not in UPDATES:
            raise ValueError(f"unknown LDPC update rule {update!r}")
        if code.M != M:
            raise ValueError(f"code {code.name}: M={code.M}, expected {M}")
        self.algo = algo
        self.update = update
        self.beta = BETA if algo == "offset-min-sum" else 0
        self.code = code
        self.max_trials = max_trials
        self.device = resolve_device(device)
        self.q, self.K, self.N = code.q, code.K, code.N
        self.edges = layer_edges(code)
        self.max_deg = max(len(e) for e in self.edges) + 2
        self._rows = [
            torch.as_tensor(edge_rows(code, i, self.edges), device=self.device)
            for i in range(self.q)
        ]
        self._runs = [write_runs(e) for e in self.edges]
        # parity check over all layers at once: padded edge slots and the
        # dead layer-0 row-0 edge point at a sentinel row holding 127
        # (neither negative nor zero)
        rows_all = np.full((self.q, self.max_deg, M), self.N, np.int64)
        for i in range(self.q):
            er = edge_rows(code, i, self.edges)
            rows_all[i, : er.shape[0]] = er
        rows_all[0, len(self.edges[0]) + 1, 0] = self.N
        self._rows_all = torch.as_tensor(rows_all, device=self.device)

    def _bad(self, st):
        """(B,) bool: True where any check of the frame is unsatisfied
        (a zero LLR counts as unsatisfied)."""
        ext = torch.cat([st, torch.full_like(st[:1], 127)], dim=0)
        vals = ext[self._rows_all]                     # (q, E, 360, B)
        sign = (vals < 0).sum(dim=1) & 1
        unsat = (sign == 1) | (vals == 0).any(dim=1)
        return unsat.flatten(0, 1).any(dim=0)

    def _update_layer(self, i, st, msgs, first, active):
        rows = self._rows[i]
        E = rows.shape[0]
        B = st.shape[1]
        vals = st[rows]                                 # (E, 360, B)
        old = msgs[i, :E]
        inp = vals if first else vals - old
        inp = inp.clamp(-128, 127)
        if i == 0:
            inp[E - 1, 0] = 127                         # missing edge: inert
        if self.algo == "min-sum-c":
            out = minc_exclusive(inp)
            # the reference's MinSumCAlgorithm stores messages saturated to
            # int8 only, with no +-32 clamp
            new_msgs = out.clamp(-128, 127)
        else:
            out = check_node(inp, self.beta)
            new_msgs = out.clamp(MSG_CLAMP_LO, MSG_CLAMP_HI)
        if self.update == "self-corrected":
            # keep the new message only where the old one was zero or has
            # the same sign (reference SelfCorrectedUpdate, generic.hh:25)
            keep = (old == 0) | ((old < 0) == (new_msgs < 0))
            new_msgs = torch.where(keep, new_msgs, 0)
        # new value = sat(inp + out) with the unclamped check output,
        # written back as deltas so repeated blocks compose
        delta = (inp + out).clamp(-128, 127) - vals
        if i == 0:
            new_msgs[E - 1, 0] = 0
            delta[E - 1, 0] = 0
        delta = torch.where(active, delta, 0)
        # the kernel keeps these packed (default rule): pack_layer_msgs(inp)
        # unpacks to exactly new_msgs
        msgs[i, :E] = new_msgs
        for a, b in self._runs[i]:
            ix = rows[a:b].reshape(-1)
            st[ix] = (st[ix] + delta[a:b].reshape(-1, B)).clamp(-128, 127)

    def _run_decode(self, st):
        """Decode the flat int32 state in place; returns (iters, bad,
        the iterations each frame entered unconverged (B,) int32)."""
        B = st.shape[1]
        msgs = torch.zeros((self.q, self.max_deg, M, B), dtype=torch.int32,
                           device=st.device)
        bad = self._bad(st)
        frame_iters = torch.zeros((B,), dtype=torch.int32, device=st.device)
        it = 0
        while it < self.max_trials and bool(bad.any()):
            frame_iters += bad
            for i in range(self.q):
                self._update_layer(i, st, msgs, it == 0, bad)
            bad = bad & self._bad(st)
            it += 1
        return it, bad, frame_iters

    def _decode(self, llrsT):
        if llrsT.dtype != torch.int8 or llrsT.shape[0] != self.N:
            raise ValueError(f"expected ({self.N}, B) int8 LLRs")
        st = to_state(llrsT.to(self.device, torch.int32), self.code)
        it, bad, frame_iters = self._run_decode(st)
        out = from_state(st, self.code).to(torch.int8)
        return (out < 0).to(torch.uint8), out, it, frame_iters, ~bad

    def decode_lane_major(self, llrsT):
        hard, out, it, _, conv = self._decode(llrsT)
        iters = torch.tensor(it, dtype=torch.int32, device=out.device)
        return hard, out, iters, conv

    def decode_frames(self, llrsT):
        hard, out, _, frame_iters, conv = self._decode(llrsT)
        return hard, out, frame_iters, conv

    def __call__(self, llrs):
        hard_t, out_t, iters, conv = self.decode_lane_major(
            llrs.transpose(0, 1).contiguous()
        )
        return hard_t.t().contiguous(), out_t.t().contiguous(), iters, conv

