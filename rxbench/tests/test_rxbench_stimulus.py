"""The traffic generator: the same seed gives the same ring, another seed
another; every channel carries its own order of the pool's frames; the
ring is cyclic over whole frames."""

import numpy as np
import torch

from rxbench.stimulus import Stimulus
from rxbench.tests._small import small_cell

SEED = 2**31 + 12345


def _stim(workload, seed):
    c = small_cell(workload)
    return Stimulus(c.config, c.traffic, seed, "cpu")


def test_same_seed_same_ring():
    a, b = _stim("ccm-qpsk12-64ch-10db", SEED), _stim("ccm-qpsk12-64ch-10db",
                                                     SEED)
    assert torch.equal(a.wave, b.wave)
    assert np.array_equal(a.order, b.order)
    assert all(np.array_equal(x, y) for x, y in zip(a.bbframes, b.bbframes))


def test_other_seed_other_ring():
    a, b = _stim("ccm-qpsk12-64ch-10db", SEED), _stim("ccm-qpsk12-64ch-10db",
                                                     SEED + 1)
    assert not torch.equal(a.wave, b.wave)
    assert not all(np.array_equal(x, y)
                   for x, y in zip(a.bbframes, b.bbframes))


# two MODCODs alternating, as a VCM carrier's schedule
TWO = {"tx": [{"modcod": "qpsk1/2", "frame_size": "short", "pilots": True},
              {"modcod": "8psk3/5", "frame_size": "short", "pilots": True}],
       "schedule": [0, 1]}


def test_ring_geometry():
    c = small_cell("ccm-qpsk12-64ch-10db", TWO, {"ring_frames": 6,
                                                "pool_frames": 6,
                                                "esn0_db": 13.0})
    s = Stimulus(c.config, c.traffic, SEED, "cpu")
    R = c.traffic["ring_frames"]
    assert s.order.shape == (2, R)
    # each channel: a permutation within each MODCOD, the schedule kept
    for row in s.order:
        assert sorted(row.tolist()) == list(range(R))
        assert np.array_equal(s.kinds[row], np.arange(R) % 2)
    assert s.wave.shape == (2, int(s.frame_samples.sum()), 2)
    assert s.n_samples == int(s.frame_samples.sum())
    # unit signal power plus noise at the stated Es/N0 and sps
    p = float((s.wave ** 2).sum(-1).mean())
    esn0 = 10 ** (c.traffic["esn0_db"] / 10)
    assert abs(p - (1 + 2 / esn0)) < 0.05


def test_host_window_wraps():
    s = _stim("ccm-qpsk12-64ch-10db", SEED)
    N = s.n_samples
    w = s.host_window(N - 5, 10)
    ref = s.wave[:, list(range(N - 5, N)) + list(range(5))].numpy()
    assert np.array_equal(w, ref[..., 0] + 1j * ref[..., 1])
