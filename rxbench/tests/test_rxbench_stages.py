"""The step glue split by the stage layouts the traced calls record: on
a synthetic trace the eight stage metrics add up to ``glue_ms`` with
nothing unattributed, a marker counts as no layer's time, each segment
is walked by itself with its own calls (its first call short of its
first few events still fits), a copy node run as a kernel still fits, a
replay that does not fit its layout is counted as unattributed, and a
trace without layouts reads nothing."""

import pytest

from rxbench import spec
from rxbench.metrics import _stages
from rxbench.run import ROOT
from rxbench.trace import TraceView

CELL = spec.cell(spec.load_bench(ROOT), "ccm-qpsk12-64ch-10db", ROOT)
STAGES = ("inputs", "frontend", "windows", "plsync", "fec", "snr",
          "tracking", "outputs")
GEOM = {"channels": 64, "frames_per_step": 2, "n_in": 129_960,
        "n_out": 64_980, "history": 39, "frame_len": 32_490,
        "payload_len": 32_400, "n_ldpc": 64_800, "n_mod": 2,
        "xfec_len": 32_400, "header_syms": 90}
GLUE = "void at::native::elementwise_kernel<128, 2>(int)"
COPY = "Memcpy DtoD (Device -> Device)"


def _layout(steps):
    """The graph's stages as the capture counts them: no event in the
    step's own ``inputs``, a glue kernel in every other stage, a copy
    beside it in ``windows``, and the front end's and the LDPC kernel."""
    one = {"inputs": (0, 0, 0), "frontend": (2, 0, 0),
           "windows": (1, 1, 0), "fec": (2, 0, 0)}
    return tuple((st,) + one.get(st, (1, 0, 0))
                 for _ in range(steps) for st in STAGES)


def _range(t, steps, head=1):
    """The host range a traced call records its head and layout in."""
    return ("rx.layout " + str(head) + " " + " ".join(
        f"{st}:{k},{c},{f}" for st, k, c, f in _layout(steps)), t, 0.0)


def _call(t0, steps):
    """One traced call on one stream: its block copy, then each step's
    stages (stage k's glue kernel lasting k us, the ``windows`` copy
    3 us) beside the layers' kernels, then the copies to the host; and
    its host range."""
    ev = [(COPY, t0 + 2, 40.0, "gpu_memcpy")]
    t = t0 + 50
    for _ in range(steps):
        for k, st in enumerate(STAGES):
            if st == "inputs":
                continue
            ev.append((GLUE, t, float(k), "kernel"))
            if st == "windows":
                ev.append((COPY, t + 10, 3.0, "gpu_memcpy"))
            if st == "fec":
                ev.append(("void ldpc_layered_kernel<21, false>(char*)",
                           t + 10, 30.0, "kernel"))
            if st == "frontend":
                ev.append(("frontend_rotate_kernel", t + 10, 20.0, "kernel"))
            t += 40
    ev.append(("Memcpy DtoH (Device -> Pinned)", t, 5.0, "gpu_memcpy"))
    return ev, [_range(t0 - 1, steps)], t + 10


def _segment(t, calls, steps):
    dev, host = [], []
    for _ in range(calls):
        ev, hr, t = _call(t, steps)
        dev += ev
        host += hr
    return dev[::-1], host, t            # a trace's order is not time's


def _view(calls=3, steps=2, layout=True):
    dev, host, _ = _segment(0.0, calls, steps)
    return TraceView([(dev, host if layout else [], calls * steps,
                       list(range(calls)))], CELL.patterns, GEOM, {}, None)


def _read(name, view):
    return spec.metric(name).read(view)


def test_stage_metrics_are_the_cells():
    names = [m["name"] for m in CELL.per_layer]
    assert [n for n in names if n.startswith("glue_") and n != "glue_ms"] \
        == [f"glue_{st}_ms" for st in STAGES]
    assert "rxspan_*" in CELL.patterns


def test_the_layout_reads_back_from_its_range():
    assert _stages._layout(_range(0.0, 2, head=3)[0]) == (3, _layout(2))


def test_stages_add_up_to_the_glue_with_nothing_outside():
    v = _view()
    got = {st: _read(f"glue_{st}_ms", v) for st in STAGES}
    assert v.unattributed == (0, 0.0)
    assert sum(got.values()) == pytest.approx(_read("glue_ms", v))
    # per step: the call's block copy (40 us a call, 3 calls of 2 steps),
    # each stage's glue kernel, the windows copy
    want = {st: k / 1e3 for k, st in enumerate(STAGES)}
    want["inputs"] = 40.0 * 3 / 6 / 1e3
    want["windows"] += 3.0 / 1e3
    assert got == pytest.approx(want)


def test_a_marker_is_no_layers_time():
    ev, hr, _ = _call(0.0, 1)
    ev.append(("rxspan_fec_kernel()", 1e4, 1.0, "kernel"))
    v = TraceView([(ev, [], 1, [0])], CELL.patterns, GEOM, {}, None)
    assert v.unmatched_us() == pytest.approx(sum(range(1, 8)) + 3.0 + 40.0)
    assert _read("ldpc_ms", v) == pytest.approx(30.0 / 1e3)
    assert _read("frontend_ms", v) == pytest.approx(20.0 / 1e3)


@pytest.mark.parametrize("lost", [0, 1, 2, 3])
def test_each_segment_is_walked_by_itself(lost):
    """Two segments seconds apart, each of two calls, the second short of
    its first events (as the profiler can drop a segment's first few:
    the block copy, the replay's first kernels): what is left of its
    first call still fits the layout's end."""
    first, h1, t = _segment(0.0, 2, 1)
    second, h2, _ = _segment(t + 5e6, 2, 1)
    second = sorted(second, key=lambda e: e[1])[lost:]
    v = TraceView([(first, h1, 2, [0, 1]), (second, h2, 2, [2, 3])],
                  CELL.patterns, GEOM, {}, None)
    by = _stages.glue_by_stage(v)
    assert v.unattributed == (0, 0.0)
    assert by["inputs"] == pytest.approx(40.0 * (4 - (lost > 0)))
    assert by["frontend"] == pytest.approx(1.0 * (4 - (lost > 1)))
    assert by["outputs"] == pytest.approx(4 * 7.0)
    assert sum(by.values()) == pytest.approx(v.unmatched_us())


def test_a_copy_node_run_as_a_kernel_still_fits():
    """The CUDA driver can run a graph's copy node as its own kernel
    (``memcpy32_post``): the call still fits, that kernel in the copy's
    stage."""
    ev, hr, _ = _call(0.0, 1)
    ev = [("memcpy32_post", s, d, "kernel") if n == COPY and d == 3.0
          else (n, s, d, c) for n, s, d, c in ev]
    v = TraceView([(ev, hr, 1, [0])], CELL.patterns, GEOM, {}, None)
    by = _stages.glue_by_stage(v)
    assert v.unattributed == (0, 0.0)
    assert by["windows"] == pytest.approx(2.0 + 3.0)
    assert by["inputs"] == pytest.approx(40.0)


def test_a_replay_that_fits_no_layout_is_unattributed(capsys):
    """The last call short of its replay's first glue kernel: its block
    copy would stand where the replay has no copy node, so it fits
    nothing, and neither it nor the call before it is placed; the walk
    says so."""
    dev, host, _ = _segment(0.0, 2, 1)
    dev = sorted(dev, key=lambda e: e[1])
    n = len(dev) // 2
    assert dev[n][0] == COPY and dev[n + 1][0] == GLUE
    dev = dev[:n + 1] + dev[n + 2:]
    v = TraceView([(dev, host, 2, [0, 1])], CELL.patterns, GEOM, {}, None)
    by = _stages.glue_by_stage(v)
    events, us = v.unattributed
    assert by == {} and events > 0
    assert us == pytest.approx(v.unmatched_us())
    assert "fit no stage layout" in capsys.readouterr().err


def test_no_layout_reads_nothing():
    v = _view(layout=False)
    assert all(_read(f"glue_{st}_ms", v) is None for st in STAGES)
    assert _read("glue_ms", v) is not None
