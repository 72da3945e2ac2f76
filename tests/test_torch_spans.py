"""The stream steps' stage spans (``dvbs2rx_tpu_torch/utils/spans.py``).

On the CPU: with spans off a span records and launches nothing; with them
on, under ``torch.profiler``, an eager CCM or VCM step emits its
``rx.<stage>`` ranges in stage order once a step, and the engines their
host spans; the marker kernels' order in ``csrc/spans.cu`` is the one
``utils.spans`` indexes. On the card (marked ``cuda``, skipped without
one; ``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``):
an untraced scan launches no marker, a profiled call replays the one
graph, launches no marker and gives its outputs bit for bit, and the
layout the capture counted places every device event of a profiled call
in its stage.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvbs2rx_tpu_torch.convert import vcm_state_from_numpy
from dvbs2rx_tpu_torch.ops import cplx
from dvbs2rx_tpu_torch.rx.receiver import RxConfig
from dvbs2rx_tpu_torch.rx.stream import StreamEngine, StreamReceiver
from dvbs2rx_tpu_torch.rx.vcm_stream import VCMStreamEngine, VCMStreamReceiver
from dvbs2rx_tpu_torch.spec.pls import make_pls
from dvbs2rx_tpu_torch.tx.transmitter import (
    Transmitter,
    TxConfig,
    awgn_channel,
)
from dvbs2rx_tpu_torch.tx.vcm import VCMTransmitter
from dvbs2rx_tpu_torch.utils import spans

torch.set_num_threads(2)

SRC = Path(spans.__file__).resolve().parent.parent / "csrc" / "spans.cu"
CCM_TX = dict(modcod="qpsk1/2", frame_size="short")
CCM = dict(CCM_TX, ldpc_max_trials=1)
VCM = dict(modcod="qpsk1/2", frame_size="short", acm_vcm=True,
           pls_expected=(make_pls(4, True, True), make_pls(12, True, True)),
           coarse_period=2)
VCM_TX = (TxConfig(modcod="qpsk1/2", frame_size="short", pilots=True),
          TxConfig(modcod="8psk3/5", frame_size="short", pilots=True))


def _ranges(prof):
    """The rx.* ranges a profile recorded, in time order."""
    ev = sorted((e for e in prof.events() if e.name.startswith("rx.")),
                key=lambda e: e.time_range.start)
    return [e.name[3:] for e in ev]


def _all_threads():
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


def _ccm_iq(sr, n_steps, seed=3):
    """(C, n) complex64 of the short QPSK 1/2 stream at 15 dB: prime and
    ``n_steps`` steps of ``sr``."""
    tx = Transmitter(TxConfig(**CCM_TX))
    rng = np.random.default_rng(seed)
    n_frames = (sr._n_fe + n_steps * sr.n_in) // (2 * sr.frame_len) + 4
    pkts = rng.integers(0, 256, (n_frames * tx.df_bytes // 188 + 2, 188),
                        dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq1 = awgn_channel(tx.ts_to_iq(pkts.reshape(-1)), 15.0, sps=2,
                       seed=seed)
    return np.stack([iq1] * sr.n_channels)


def _vcm_iq(sr, n_steps, seed=4):
    vtx = VCMTransmitter(list(VCM_TX))
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (420, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    iq1 = awgn_channel(vtx.ts_to_iq(pkts.reshape(-1), [0, 1]), 15.0, sps=2,
                       seed=seed)
    assert iq1.size >= sr._n_fe + n_steps * sr.n_in
    return np.stack([iq1] * sr.n_channels)


# ---------------------------------------------------------------- CPU


def test_marker_order_is_the_sources():
    src = SRC.read_text()
    listed = re.search(r"#define RXSPAN_STAGES\(X\)(.*?)\n\n", src, re.S)
    assert tuple(re.findall(r"X\((\w+)\)", listed.group(1))) == \
        spans.MARKED
    assert set(spans.STAGES) | set(spans.VCM_STAGES) == set(spans.MARKED)
    assert not set(spans.HOST) & set(spans.MARKED)


def test_spans_off_record_and_launch_nothing():
    before = spans.LAUNCHES
    assert not spans._on
    assert spans.span("fec", torch.device("cpu")) is spans.span("snr")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in spans.STAGES:
            with spans.span(name, torch.device("cpu")):
                pass
    assert _ranges(prof) == []
    assert spans.LAUNCHES == before


def test_eager_ccm_step_emits_its_stages_in_order():
    """Under a profile, an eager step with spans off records no range;
    with them on a step records its stages once, in ``STAGES`` order, and
    its outputs are the spanless step's (the engine test below runs
    several steps)."""
    sr = StreamReceiver(RxConfig(**CCM), n_channels=1, frames_per_step=1,
                        device="cpu")
    state = sr.put_state(sr.init_state_np())
    iq = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, sr.n_in, 2)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s_off, kb_off, st_off = sr.step(state, iq)
    assert _ranges(prof) == []
    with spans.switch(True), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        s1, kb, st = sr.step(state, iq)
    assert not spans._on
    assert _ranges(prof) == list(spans.STAGES)
    assert torch.equal(kb, kb_off)
    for k, v in st_off.items():
        assert torch.equal(st[k], v), k
    for k, v in s_off.items():
        assert torch.equal(s1[k], v), k


def test_eager_vcm_step_emits_its_stages_in_order():
    sr = VCMStreamReceiver(RxConfig(**VCM), 1, 2, 8, device="cpu")
    state = vcm_state_from_numpy(sr.init_state_np(), "cpu")
    iq = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, sr.n_in, 2)).astype(np.float32))
    with spans.switch(True), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        sr.step(state, iq)
    assert _ranges(prof) == list(spans.VCM_STAGES)


def test_layout_counts_each_stage_run(monkeypatch):
    """A layout's stages are the nodes between its marks, a stage that
    continues itself merged, the last up to the capture's end."""
    counts = iter([(0, 0, 0), (2, 1, 0), (2, 1, 0), (5, 1, 1), (6, 2, 1)])
    monkeypatch.setattr(spans.Layout, "_nodes", lambda self: next(counts))
    rec = spans.Layout(None, "inputs")
    for stage in ("frontend", "outputs", "outputs"):
        rec.mark(stage)
    rec.close()
    assert rec.stages == (("inputs", 2, 1, 0), ("frontend", 0, 0, 0),
                          ("outputs", 4, 1, 1))
    assert rec.name(1) == \
        "rx.layout 1 inputs:2,1,0 frontend:0,0,0 outputs:4,1,1"


def test_place_fits_the_last_events_stage_for_stage():
    stages = (("a", 2, 0, 0), ("b", 1, 1, 0))
    assert spans.place([1, 0, 0, 0, 1], stages) == \
        [None, "a", "a", "b", "b"]
    # a copy node run as a kernel still fits
    assert spans.place([0, 0, 0, 0], stages) == ["a", "a", "b", "b"]
    # a copy where the stage has no copy node; too few events
    assert spans.place([0, 1, 0, 0], stages) is None
    assert spans.place([0, 0, 1], stages) is None


@pytest.mark.parametrize("kind", ["ccm", "vcm"])
def test_engine_host_spans(kind):
    """An engine's receive over prime and three steps: the re-blocking of
    each call and step, and each step's readback, statistics and stitch
    (the CCM stitch on the reader thread)."""
    steps = 3
    if kind == "ccm":
        eng = StreamEngine(RxConfig(**CCM), n_channels=1, device="cpu")
        iq = _ccm_iq(eng.sr, steps)
    else:
        eng = VCMStreamEngine(RxConfig(**VCM), n_channels=1, fec_lanes=8,
                              device="cpu")
        iq = _vcm_iq(eng.sr, steps)
    n = eng.sr._n_fe + steps * eng.sr.n_in
    try:
        with spans.switch(True), profile(activities=[ProfilerActivity.CPU],
                                         experimental_config=_all_threads(
                                         )) as prof:
            eng.receive(iq[:, :n], flush=kind == "ccm")
    finally:
        if kind == "ccm":
            eng.close()
    ranges = _ranges(prof)
    got = [s for s in ranges if s in spans.HOST]
    assert set(got) == set(spans.HOST), got
    assert got.count("engine.reblock") == 1 + steps
    for name in ("session.readback", "engine.stats", "engine.stitch"):
        assert got.count(name) == steps, (name, got)
    stages = spans.STAGES if kind == "ccm" else spans.VCM_STAGES
    assert [s for s in ranges if s in stages] == list(stages) * steps


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scan_case(C=2, T=2):
    sr = StreamReceiver(RxConfig(**CCM), n_channels=C, device="cuda")
    iq = _ccm_iq(sr, T)
    blocks = torch.as_tensor(np.stack([
        cplx.from_np(iq[:, sr._n_fe + t * sr.n_in:
                        sr._n_fe + (t + 1) * sr.n_in]).astype(np.float32)
        for t in range(T)]), device="cuda")
    return sr, sr.prime(iq[:, : sr._n_fe]), blocks


def _cloned(out):
    state, kb, stats = out
    return ({k: v.clone() for k, v in state.items()}, kb.clone(),
            {k: v.clone() for k, v in stats.items()})


def _profiled(fn, cpu=True):
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def _kind(name):
    """A profiler device event's kind as ``spans.place`` numbers it."""
    return 1 if name.startswith("Memcpy") else \
        2 if name.startswith("Memset") else 0


def _device_events(prof):
    return sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("rx.")),
                  key=lambda e: e.time_range.start)


@pytest.mark.cuda
def test_untraced_scan_launches_no_marker(card):
    sr, primed, blocks = _scan_case()
    scan = sr.make_scan_step(2)
    before = spans.LAUNCHES
    state = scan(primed, blocks)[0]
    scan(state, blocks)
    torch.cuda.synchronize()
    assert spans.LAUNCHES == before
    assert list(scan._graphs) == [0]
    assert scan.launches_per_call["rxspan"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cpu", [True, False], ids=["cpu+cuda", "cuda"])
def test_profiled_call_replays_the_one_graph(card, cpu):
    """The same state and blocks through the scan without and under a
    profile: one graph, no capture more, no marker, and kbytes, every
    statistic and the final state equal bit for bit."""
    T = 2
    sr, primed, blocks = _scan_case(T=T)
    scan = sr.make_scan_step(T)
    plain = _cloned(scan(primed, blocks))
    held = dict(scan.launches_per_call)
    graph = scan._graphs[0]
    before = spans.LAUNCHES
    traced, _ = _profiled(lambda: _cloned(scan(primed, blocks)), cpu)
    assert spans.LAUNCHES == before
    assert scan._graphs == {0: graph}
    assert scan.launches_per_call == held
    assert torch.equal(traced[1], plain[1])
    for part in (0, 2):
        assert traced[part].keys() == plain[part].keys()
        for k, v in plain[part].items():
            assert torch.equal(traced[part][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("fed", ["own", "primed"])
def test_layout_places_every_event_of_a_profiled_call(card, fed):
    """The capture's layout runs through ``STAGES`` once a step and holds
    every launch the graph counts; a profiled call records it in the
    trace with the number of its copies' device events, and its device
    events are those copies, then the replay's, which fit the layout
    stage for stage. Fed the state the last call returned, a call copies
    the blocks alone; fed another state, each of its tensors too."""
    T = 2
    sr, primed, blocks = _scan_case(T=T)
    scan = sr.make_scan_step(T)
    state = scan(primed, blocks)[0]
    if fed == "primed":
        state = primed
    layout = scan._graphs[0].layout
    stages = layout.stages
    assert [s[0] for s in stages] == list(spans.STAGES) * T
    assert sum(s[1] for s in stages) >= sum(scan.launches_per_call.values())
    head = 1 if fed == "own" else 1 + sum(v.numel() > 0
                                          for v in primed.values())

    def call():
        # the profiler can drop a profile's first few device events:
        # eight markers go first, and the call's events follow the last
        for _ in range(8):
            spans.marker("inputs", card)
        torch.cuda.synchronize()
        return scan(state, blocks)

    _, prof = _profiled(call)
    assert [e.name for e in prof.events()
            if e.name.startswith(spans.LAYOUT)] == [layout.name(head)]
    dev = _device_events(prof)
    last = max(i for i, e in enumerate(dev) if "rxspan_" in e.name)
    kinds = [_kind(e.name) for e in dev[last + 1:]]
    assert len(kinds) == head + sum(sum(s[1:]) for s in stages)
    placed = spans.place(kinds, stages)
    assert placed is not None, (len(kinds), stages)
    assert placed[:head] == [None] * head and None not in placed[head:]
    assert kinds[head - 1] == 1                 # the block copy


@pytest.mark.cuda
def test_eager_card_step_marks_its_stages(card):
    sr, primed, blocks = _scan_case(T=1)
    off = _cloned(sr.step(primed, blocks[0]))
    before = spans.LAUNCHES
    with spans.switch(True):
        on = _cloned(sr.step(primed, blocks[0]))
    torch.cuda.synchronize()
    assert spans.LAUNCHES == before + len(spans.STAGES)
    assert torch.equal(on[1], off[1])
    for part in (0, 2):
        for k, v in off[part].items():
            assert torch.equal(on[part][k], v), k
