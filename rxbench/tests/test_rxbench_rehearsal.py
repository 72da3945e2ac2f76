"""The cell's loop rehearsed on the CPU at 2 channels and short frames: a
sound run comes out correct with the result line's schema; the control
(the plain front end in TF32 in the program's place) and each fault the
cell can have, planted under the timed path, come out not correct."""

import json

import numpy as np
import pytest
import torch

from rxbench.reference.frontend import tf32
from rxbench.run import run_cell
from rxbench.tests._small import small_cell

CELLS = ["ccm-qpsk12-64ch-10db"]
SEED = 2**31 + 77


def _run(workload, seed=SEED, seconds=3.0, **kw):
    return run_cell(small_cell(workload), seed, seconds, device="cpu", **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run(workload):
    r = _run(workload)
    assert r["correct"], r["limits"]
    lim = r["limits"]
    assert {"fe_sym_gap", "fe_tau_gap", "crc_map_diff"} <= set(lim)
    assert lim["fe_sym_gap"]["value"] < lim["fe_sym_gap"]["limit"] / 10
    assert r["failed"] == 0 and r["attempted"] > 0
    keys = list(r)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "limits"
    assert {"metrics", "device"} <= set(keys)
    assert set(r["metrics"]) == {"rx_msps", "rx_latency_p95_ms", "setup_s"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(r["device"])
    json.loads(json.dumps(r))


def test_traced_run_schema():
    r = _run(CELLS[0], trace=True, seconds=8.0)
    assert r["correct"], r["limits"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    r = _run(workload, control=True)
    assert not r["correct"]
    gap = r["limits"]["fe_sym_gap"]
    assert gap["value"] > 3 * gap["limit"], gap


def test_ldpc_off_fails():
    r = _run(CELLS[0], rx_fault="ldpc_off", seconds=2.5)
    assert not r["correct"]
    assert r["limits"]["wrong_frames"]["value"] > 0


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      1.0 + 2.0**-10 + 2.0**-12, -3.0e-5])
    got = tf32(x)
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 2^-11 -> 1 + 2^-9
    assert got[:4].tolist() == [1.0, 1.0, 1.0 + 2.0**-9, 1.0 + 2.0**-10]
    assert abs(got[4] / x[4] - 1) <= 2.0**-11


class _Frozen:
    """A step that returns its state unchanged: every call starts from the
    state the window began with."""

    def __init__(self, drv):
        self.drv, self.saved = drv, None

    def __getattr__(self, k):
        return getattr(self.drv, k)

    def call(self, index, snap=False):
        if self.saved is None:
            self.saved = self.drv.state
        self.drv.state = self.saved
        return self.drv.call(index, snap)


class _Leaves:
    """A change to what a call returns, where it is produced."""

    def __init__(self, drv, edit):
        self.drv, self.edit = drv, edit

    def __getattr__(self, k):
        return getattr(self.drv, k)

    def call(self, index, snap=False):
        return [self.edit(name, t, n)
                for name, t, n in self.drv.call(index, snap)]


def _bf16(drv):
    """The front end's output in bfloat16: the symbols each call leaves in
    its state rounded to 8-bit mantissas where the scan returns them."""
    scan = drv.scan

    def rounded(state, blocks):
        st, kb, stats = scan(state, blocks)
        st["sym_tail"] = st["sym_tail"].to(torch.bfloat16).float()
        return st, kb, stats

    drv.scan = rounded
    return drv


def _half(name, t, n):
    """Half of the batch left out: the second half of the channels' frames
    never delivered."""
    if name == "kbytes":
        t = t.clone()
        t[:, t.shape[1] // 2:] = 0
    return name, t, n


def _altered(name, t, n):
    """One byte of every call's first delivered frame altered."""
    if name == "kbytes":
        t = t.clone()
        t.view(-1)[17] ^= torch.tensor(1, dtype=t.dtype)
    return name, t, n


FAULTS = {"frozen": _Frozen,
          "half": lambda d: _Leaves(d, _half),
          "altered": lambda d: _Leaves(d, _altered),
          "bf16": _bf16}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails(workload, fault):
    r = _run(workload, fault=FAULTS[fault], seconds=2.5)
    assert not r["correct"], (fault, r["limits"])


class _Records:
    """A driver stand-in whose calls each deliver 100 frames."""

    steps_per_call = 1

    @staticmethod
    def flagged(rec):
        return {"hdr_crc_failed": rec["hdr_ok"] == 0}

    def records(self, index, host):
        n = 100
        return {"chan": np.arange(n) % 4, "place": index * n + np.arange(n),
                "kind": np.zeros(n, np.int64),
                "rows": np.full((n, 8), index, np.uint8),
                "hdr_ok": np.ones(n, np.int32)}


def _kept(seed):
    from rxbench.checker import Checker

    ch = Checker(_Records(), {}, {"check_frames": 256}, seed, 2)
    for i in range(60):
        ch.on_land(i, 0.0, 1.0, {}, None)
    return np.sort(ch.kept["place"])


def test_sample_is_drawn_from_the_seed():
    a, b, c = _kept(5), _kept(5), _kept(6)
    assert a.size == 256 and np.unique(a).size == 256
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # only window calls (index >= 2), spread over all of them
    assert a.min() >= 200 and a.max() >= 5000
