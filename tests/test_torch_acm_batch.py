"""The port's ``BatchedACMReceiver`` (``rx/acm_batch.py``) against single
port ``ACMReceiver``s and the JAX ``BatchedACMReceiver``.

C = 3 channels of short VCM waveforms (QPSK 1/2 and 8PSK 3/5, a dummy frame
in each schedule period), each with its own packets and noise seed, fed in
two ``receive`` calls. Exact, against three single port receivers fed the
same way: each channel's TS bytes and its integer counters but the LDPC
iteration totals (a pooled channel takes the pool's batch-maximum
iteration count, as in the JAX receiver). Exact against the JAX batched
receiver: TS bytes and every integer counter, the iteration totals too.
``CallBatcher`` is checked on its own: grouping by key, results in order,
errors to every submitter of the group.
"""

import threading

import numpy as np
import pytest
import torch

from dvbs2rx_tpu.rx.acm_batch import BatchedACMReceiver as JBatchedACMReceiver
from dvbs2rx_tpu.rx.receiver import RxConfig as JRxConfig

from dvbs2rx_tpu_torch.rx.acm_batch import BatchedACMReceiver, CallBatcher
from dvbs2rx_tpu_torch.rx.receiver import ACMReceiver, RxConfig

from tests.test_torch_acm import vcm_stimulus
from tests.test_torch_receiver import INT_STATS, assert_consecutive

torch.set_num_threads(2)

C = 3
KW = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True, fec_batch=4)


@pytest.fixture(scope="module")
def streams():
    """(iq (C, n), per-channel packets) and the port's batched run."""
    stims = [vcm_stimulus([0, -1, 1], n_frames=10, seed=20 + 2 * c)
             for c in range(C)]
    n = min(s[0].size for s in stims)
    iq = np.stack([s[0][:n] for s in stims])
    brx = BatchedACMReceiver(RxConfig(**KW), C, device="cpu")
    cut = n // 2
    out1 = brx.receive(iq[:, :cut], flush=False)
    out2 = brx.receive(iq[:, cut:], flush=True)
    ts = [np.concatenate([a, b]) for a, b in zip(out1, out2)]
    return iq, [s[1] for s in stims], brx, ts


def test_batched_matches_single_port_receivers(streams):
    iq, pkts, brx, ts = streams
    cut = iq.shape[1] // 2
    for c in range(C):
        one = ACMReceiver(RxConfig(**KW), device="cpu")
        want = np.concatenate([one.receive(iq[c, :cut], flush=False),
                               one.receive(iq[c, cut:], flush=True)])
        np.testing.assert_array_equal(ts[c], want, err_msg=f"channel {c}")
        st = brx.chans[c].stats
        for k in INT_STATS:
            if k != "ldpc_total_iters":
                assert getattr(st, k) == getattr(one.stats, k), (c, k)
        assert st.ldpc_total_iters >= one.stats.ldpc_total_iters
        assert st.bch_frame_errors == 0 and st.dummy_cnt >= 2
        assert_consecutive(ts[c], pkts[c], 30)
    assert len(brx.get_stats()) == C


def test_batched_matches_jax_batched(streams):
    iq, _, brx, ts = streams
    jb = JBatchedACMReceiver(JRxConfig(**KW), C)
    cut = iq.shape[1] // 2
    j1 = jb.receive(iq[:, :cut], flush=False)
    j2 = jb.receive(iq[:, cut:], flush=True)
    for c in range(C):
        np.testing.assert_array_equal(ts[c], np.concatenate([j1[c], j2[c]]),
                                      err_msg=f"channel {c}")
        for k in INT_STATS:
            assert getattr(brx.chans[c].stats, k) == \
                getattr(jb.chans[c].stats, k), (c, k)


def test_batched_pools_fec_and_pads_to_the_channel_count(streams):
    """Every device request group runs as one call of C requests; the FEC
    calls pool C x fec_batch frames."""
    iq, _, _, _ = streams
    brx = BatchedACMReceiver(RxConfig(**KW), C, device="cpu")
    groups, padded = {}, {}
    orig = brx._batch_call

    def batch_call(fn, args_list):
        name = fn.__name__
        groups.setdefault(name, set()).add(len(args_list))
        if name == "_fec_batch":
            assert args_list[0][1].shape[0] == KW["fec_batch"]

        def counted(reqs):
            padded.setdefault(name, set()).add(len(reqs))
            return fn(reqs)

        out = orig(counted, args_list)
        assert len(out) == len(args_list)
        return out

    brx._batch_call = batch_call
    brx.receive(iq[:, : iq.shape[1] // 3], flush=True)
    assert set(groups) == {"_fe_batch", "_metric_batch", "_win_plsc_batch",
                           "_acm_group_batch", "_fec_batch", "_refine_batch"}
    assert max(max(s) for s in groups.values()) <= C
    assert all(s == {C} for s in padded.values()), padded


def test_call_batcher_groups_by_key_in_order():
    b = CallBatcher()
    log = []

    def fn(args_list):
        log.append(sorted(a[0] for a in args_list))
        return [a[0] * 10 for a in args_list]

    def work(i):
        first = b.submit(("a",), fn, (i,))
        second = b.submit(("b", i % 2), fn, (i + 100,))
        return first, second

    out = b.run([lambda i=i: work(i) for i in range(4)])
    assert out == [(0, 1000), (10, 1010), (20, 1020), (30, 1030)]
    assert log[0] == [0, 1, 2, 3]
    assert sorted(log[1:]) == [[100, 102], [101, 103]]


def test_call_batcher_sends_errors_to_the_group():
    b = CallBatcher()
    seen = []
    lock = threading.Lock()

    def bad(args_list):
        raise ValueError("stage failed")

    def work(i):
        try:
            b.submit(("x",), bad, (i,))
        except ValueError as e:
            with lock:
                seen.append(str(e))
            raise

    with pytest.raises(ValueError, match="stage failed"):
        b.run([lambda i=i: work(i) for i in range(3)])
    assert seen == ["stage failed"] * 3


def test_call_batcher_under_thread_switch_pressure():
    """More workers than cores, each submitting a different number of
    requests, with the interpreter switching threads every microsecond:
    every request gets its own result exactly once, a group never holds
    two requests of one worker, and the workers that finish early flush
    the rest. Bounded by a join timeout."""
    import sys

    b = CallBatcher()
    n_workers = 24
    groups = []

    def fn(args_list):
        owners = [a[0] for a in args_list]
        assert len(owners) == len(set(owners))
        groups.append(len(args_list))
        return [a[0] * 1000 + a[1] for a in args_list]

    def work(i):
        return [b.submit(("k", j % 3), fn, (i, j)) for j in range(2 + i % 5)]

    result = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: result.setdefault(
            "out", b.run([lambda i=i: work(i) for i in range(n_workers)])))
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert result["out"] == [[i * 1000 + j for j in range(2 + i % 5)]
                             for i in range(n_workers)]
    assert sum(groups) == sum(2 + i % 5 for i in range(n_workers))


def test_batched_receiver_checks_its_input():
    with pytest.raises(ValueError, match="acm_vcm"):
        BatchedACMReceiver(RxConfig(modcod="qpsk1/2", frame_size="short"), 2,
                           device="cpu")
    brx = BatchedACMReceiver(RxConfig(**KW), 2, device="cpu")
    with pytest.raises(ValueError, match=r"\(2, n\)"):
        brx.receive(np.zeros((3, 100), np.complex64))
    assert brx.chans[0]._tables is brx.chans[1]._tables
