"""Layered offset-min-sum LDPC decoder in plain PyTorch.

Port of the roll-based decoder ``dvbs2rx_tpu/ops/ldpc.py`` (offset-min-sum,
beta = 1, normal update; the min-sum, min-sum-c and self-corrected variants
come later). It is the plain version of the CUDA kernel in
``ldpc_cuda.py`` and the decoder that CPU tensors take.

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
the batch iteration count and per-frame convergence.

LLR convention: positive = bit 0.
"""

import numpy as np
import torch

from dvbs2rx_tpu.spec.ldpc_tables import LDPCCode

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
    """Batched layered decoder for one code table.

    ``__call__`` takes (B, N) int8 LLRs, ``decode_lane_major`` takes (N, B);
    both return (hard bits uint8, final LLRs int8, iterations int32 scalar,
    converged (B,) bool) in the layout they were given.
    """

    def __init__(self, code: LDPCCode, max_trials: int = 25, device=None):
        if code.M != M:
            raise ValueError(f"code {code.name}: M={code.M}, expected {M}")
        self.code = code
        self.max_trials = max_trials
        self.device = torch.device(device)
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
        inp = vals if first else vals - msgs[i, :E]
        inp = inp.clamp(-128, 127)
        if i == 0:
            inp[E - 1, 0] = 127                         # missing edge: inert
        mags = (inp.abs().clamp(max=127) - BETA).clamp(min=0)
        two = torch.topk(mags, 2, dim=0, largest=False).values
        min0, min1 = two[0], two[1]
        excl = torch.where(mags == min0, min1, min0)
        neg = (inp < 0).to(torch.int32)
        excl_sign = (neg.sum(dim=0, keepdim=True) & 1) ^ neg
        out = torch.where(excl_sign == 1, -excl, excl)
        new_msgs = out.clamp(MSG_CLAMP_LO, MSG_CLAMP_HI)
        # new value = sat(inp + out) with the unclamped check output,
        # written back as deltas so repeated blocks compose
        delta = (inp + out).clamp(-128, 127) - vals
        if i == 0:
            new_msgs[E - 1, 0] = 0
            delta[E - 1, 0] = 0
        delta = torch.where(active, delta, 0)
        msgs[i, :E] = new_msgs
        for a, b in self._runs[i]:
            ix = rows[a:b].reshape(-1)
            st[ix] = (st[ix] + delta[a:b].reshape(-1, B)).clamp(-128, 127)

    def _run_decode(self, st):
        """Decode the flat int32 state in place; returns (iters, bad)."""
        B = st.shape[1]
        msgs = torch.zeros((self.q, self.max_deg, M, B), dtype=torch.int32,
                           device=st.device)
        bad = self._bad(st)
        it = 0
        while it < self.max_trials and bool(bad.any()):
            for i in range(self.q):
                self._update_layer(i, st, msgs, it == 0, bad)
            bad = bad & self._bad(st)
            it += 1
        return it, bad

    def decode_lane_major(self, llrsT):
        if llrsT.dtype != torch.int8 or llrsT.shape[0] != self.N:
            raise ValueError(f"expected ({self.N}, B) int8 LLRs")
        st = to_state(llrsT.to(self.device, torch.int32), self.code)
        it, bad = self._run_decode(st)
        out = from_state(st, self.code).to(torch.int8)
        hard = (out < 0).to(torch.uint8)
        iters = torch.tensor(it, dtype=torch.int32, device=out.device)
        return hard, out, iters, ~bad

    def __call__(self, llrs):
        hard_t, out_t, iters, conv = self.decode_lane_major(
            llrs.transpose(0, 1).contiguous()
        )
        return hard_t.t().contiguous(), out_t.t().contiguous(), iters, conv

