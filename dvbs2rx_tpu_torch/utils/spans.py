"""Named stage spans of the stream steps, on the profiler's host clock and
on the device trace's.

``span(name, device)`` marks where a stage of a step begins. While spans
are off (the default) it costs one flag test: it opens no profiler range
and launches nothing. While they are on (``switch(True)``, for every
thread) it opens ``torch.profiler.record_function("rx.<name>")``, a range
on the profiler's host clock, and on a CUDA device launches the stage's
marker, the one-thread kernel ``rxspan_<name>_kernel`` of
``csrc/spans.cu``, on the current stream: on the device trace's clock an
eager step's stage runs from its marker to the next marker on the stream.
Host-only phases (the engines') pass no device.

A CUDA graph holds no marker. While a thread captures a graph inside
``layout(device)``, a span of that thread instead records how many
kernel, copy and fill nodes the graph holds where the stage begins
(``Layout``): a graph captured from one stream runs its nodes in capture
order, so the counts place each device event of a replay in its stage,
and the graph is the one a capture without spans makes.
``StreamReceiver.make_scan_step`` captures its graphs so. A call that a
``torch.profiler`` profile records (``profiling()``) opens the host
range ``rx.inputs`` around its copies into the graph's buffers and
records how many device events those copies make and the graph's layout
as an empty host range (``Layout.record``: ``rx.layout <events>
<stage>:<kernels>,<copies>,<fills> ...``), so a reader of the trace
alone can place every device event of the call. It launches no marker:
on the H100 an eager kernel between two graph launches made the launches
under the profiler, and the block copy after it, slower.
"""

import contextlib
import ctypes
import threading

import torch

from .. import _build

# the CCM stream step's stages, in the order a step passes through them
STAGES = ("inputs", "frontend", "windows", "plsync", "fec", "snr",
          "tracking", "outputs")
# the VCM stream step's: step A (front end, the chain walk and its books,
# PL sync and demap, lock and rotator, state and statistics), then step B
# (the FEC queues and their decodes)
VCM_STAGES = ("frontend", "walk", "plsync", "tracking", "outputs", "fec")
# every stage with a marker kernel, in csrc/spans.cu's order
MARKED = STAGES + ("walk",)
# the engines' host phases (no marker)
HOST = ("engine.reblock", "session.readback", "engine.stats",
        "engine.stitch")

LAUNCHES = 0        # marker launches; incremented only where one runs
LAYOUT = "rx.layout"    # the name of Layout.record's range begins so


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0


_build.register_counter("rxspan", lambda: LAUNCHES, _reset_counts)

_switched = False           # switch(): spans on for every thread
_recording = 0              # layout() captures in progress, on any thread
_on = False                 # _switched or _recording: span()'s one test
_local = threading.local()  # .layout: this thread's capture, if any
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def span(name, device=None, on=False):
    """The stage ``name`` as a context manager (see the module's note):
    nothing while spans are off, unless ``on``."""
    if not (_on or on):
        return _OFF
    return _span(name, device, on)


@contextlib.contextmanager
def _span(name, device, on):
    rec = getattr(_local, "layout", None)
    if rec is not None:
        rec.mark(name)
        yield
    elif _switched or on:
        with torch.profiler.record_function(f"rx.{name}"):
            if device is not None and device.type == "cuda":
                marker(name, device)
            yield
    else:
        yield


def marker(name, device):
    """Launch the marker kernel of stage ``name`` on ``device``'s current
    stream."""
    global LAUNCHES
    stage = MARKED.index(name)
    err = _build.lib().rxspan_launch(
        stage, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, f"rxspan_{name}_kernel")
    LAUNCHES += 1


def _set(switched=None, recording=0):
    global _switched, _recording, _on
    with _lock:
        if switched is not None:
            _switched = switched
        _recording += recording
        _on = _switched or _recording > 0


@contextlib.contextmanager
def switch(on):
    """Spans on (or off) inside the block, for every thread; as they were
    after it."""
    was = _switched
    _set(switched=bool(on))
    try:
        yield
    finally:
        _set(switched=was)


def profiling():
    """Whether a ``torch.profiler`` profile is recording on this thread:
    the profiler state that ``record_function`` records into."""
    return torch.autograd._profiler_enabled()


class Layout:
    """Where each stage begins in a graph under capture: the graph's
    kernel, copy and fill nodes counted at each span, from the stream the
    graph captures."""

    def __init__(self, stream, first):
        self.stream = stream
        self.marks = []             # (stage, (kernels, copies, fills))
        self.stages = self._text = None     # close()'s
        self.mark(first)

    def _nodes(self):
        counts = (ctypes.c_longlong * 3)()
        _build.check(_build.lib().rxspan_graph_nodes(self.stream, counts),
                     "rxspan_graph_nodes")
        return tuple(counts)

    def mark(self, stage):
        self.marks.append((stage, self._nodes()))

    def close(self):
        """Set ``stages``, ((stage, kernels, copies, fills), ...): the
        nodes between each mark and the next (the last stage's up to now),
        a stage that continues itself merged into one run."""
        ends = [n for _, n in self.marks[1:]] + [self._nodes()]
        out = []
        for (stage, a), b in zip(self.marks, ends):
            d = tuple(y - x for x, y in zip(a, b))
            if out and out[-1][0] == stage:
                d = tuple(x + y for x, y in zip(out[-1][1:], d))
                out.pop()
            out.append((stage,) + d)
        self.stages = tuple(out)
        self._text = " ".join(f"{st}:{k},{c},{f}" for st, k, c, f in out)

    def name(self, head):
        """``record``'s range name for a call whose ``head`` device events
        come before the replay's."""
        return f"{LAYOUT} {head} {self._text}"

    def record(self, head):
        """An empty host range, in a profile's trace, that names ``head``
        and the layout."""
        with torch.profiler.record_function(self.name(head)):
            pass


@contextlib.contextmanager
def layout(device, first=STAGES[0]):
    """Inside a ``torch.cuda.graph`` capture on ``device``: this thread's
    spans record where their stages begin in the graph's ``Layout``
    (yielded; closed at the end of the block). Nodes before the first
    span are stage ``first``'s."""
    rec = Layout(torch.cuda.current_stream(device).cuda_stream, first)
    _local.layout = rec
    _set(recording=1)
    try:
        yield rec
    finally:
        _local.layout = None
        _set(recording=-1)
    rec.close()


def place(kinds, stages):
    """The stage of each device event of one replay: ``kinds`` are the
    events' kinds in time order (0 kernel, 1 copy, 2 fill), ending with
    the replay's, and ``stages`` a ``Layout``'s. Returns one stage a
    kind, None for each event before the replay's (a call's copies into
    its graph's buffers), or None if the last events do not fit
    ``stages``: a stage's events as many as its nodes, with no more
    copies or fills than it has (a copy or fill node can run as a
    kernel: the CUDA driver runs small copies between device buffers as
    its own ``memcpy32_post`` kernels)."""
    n = sum(sum(s[1:]) for s in stages)
    head = len(kinds) - n
    if head < 0:
        return None
    out, i = [None] * head, head
    for stage, *want in stages:
        got = [0, 0, 0]
        for k in kinds[i: i + sum(want)]:
            got[k] += 1
        if sum(got) != sum(want) or got[1] > want[1] or got[2] > want[2]:
            return None
        out += [stage] * sum(want)
        i += sum(want)
    return out
