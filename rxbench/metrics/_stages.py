"""The step glue split by the stage spans of the program
(``dvbs2rx_tpu_torch/utils/spans.py``), shared by the ``glue_<stage>_ms``
metrics.

A traced call of the port's scan copies its state and blocks into the
graph's buffers, then replays the graph. When the program captured the
graph it counted how many kernels, copies and fills each stage of each
step puts into a replay, and a traced call records, as an empty host
range named ``rx.layout <head> <stage>:<kernels>,<copies>,<fills> ...``,
how many device events its copies make (``head``) and those counts. A
graph captured from one stream runs its nodes in capture order, so on
the cell's one stream a call's device events are its ``head`` copies,
then the replay's events stage by stage.

The walk takes each profiled segment in turn (``TraceView.spans``: a
segment runs from its first device event for its span; its calls are
the ``rx.layout`` ranges recorded after the last segment's end and
before its own) and goes back from the segment's last event, call by
call: the last events are the call's replay, laid over the layout stage
for stage (as many events as nodes, no more copies or fills than nodes:
a copy node can run as a kernel, the CUDA driver's ``memcpy32_post``), the
``head`` events before them its ``inputs``. The segment's first call may
be short of its first events (the profiler can drop a segment's first
few, on the H100 up to the block copy and the replay's first two
kernels): what is left of it is the end of a replay. Each glue event
(what ``TraceView.unmatched_us`` counts: no layer metric's pattern
claims it, copies to the host aside) adds its time to its stage. Events
that no call accounts for, or that sit where a replay does not fit its
layout, are unattributed: ``glue_by_stage`` counts them and says so on
stderr, and the stages then add up to less than ``glue_ms``. The stage
metrics claim the eager steps' markers (``PATTERNS``), so no other
metric, the glue included, would count one.
"""

import fnmatch
import sys

from rxbench.trace import bare_name

PATTERNS = ("rxspan_*",)
LAYOUT = "rx.layout "
KINDS = {"kernel": 0, "gpu_memcpy": 1, "gpu_memset": 2}
SLACK_US = 1.0      # rounding of a segment's end (segments lie seconds apart)


def _layout(name):
    """(head, ((stage, kernels, copies, fills), ...)) of a range name."""
    head, *parts = name[len(LAYOUT):].split()
    stages = []
    for part in parts:
        stage, counts = part.rsplit(":", 1)
        stages.append((stage,) + tuple(int(n) for n in counts.split(",")))
    return int(head), tuple(stages)


def _segments(view):
    """Each profiled segment: its device events in time order (copies to
    the host left out) and its calls' layouts in time order."""
    ev = sorted(view.device, key=lambda e: e[1])
    calls = sorted((s, _layout(n)) for n, s, _ in view.host
                   if n.startswith(LAYOUT))
    i, c = 0, 0
    for span in view.spans:
        if i >= len(ev):
            return
        end = ev[i][1] + span + SLACK_US
        j = i
        while j < len(ev) and ev[j][1] <= end:
            j += 1
        k = c
        while k < len(calls) and calls[k][0] <= end:
            k += 1
        yield ([e for e in ev[i:j]
                if not (e[3] == "gpu_memcpy" and "DtoH" in e[0])],
               [lay for _, lay in calls[c:k]])
        i, c = j, k


def _fits(got, want):
    """A stage's events against its nodes, each [kernels, copies, fills]:
    as many events as nodes, and no more copies or fills than nodes (a
    copy or fill node can run as a kernel: the CUDA driver runs small copies
    between device buffers as its own ``memcpy32_post`` kernels)."""
    return sum(got) == sum(want) and got[1] <= want[1] and \
        got[2] <= want[2]


def _replay(kinds, stages):
    """The stage of each of ``kinds``, the last events of a replay laid
    over ``stages`` from its end (the first stage they reach may be short
    of its first events); None if they do not fit."""
    parts, end = [], len(kinds)
    for stage, *want in reversed(stages):
        n = min(sum(want), end)
        got = [0, 0, 0]
        for k in kinds[end - n:end]:
            if k >= 0:
                got[k] += 1
        if not (_fits(got, want) or n < sum(want) and got[1] <= want[1]
                and got[2] <= want[2]):
            return None
        parts.append([stage] * n)
        end -= n
    return sum(reversed(parts), [])


def _place(events, calls):
    """Each event's stage (None: unattributed), going back from the last
    event one call at a time."""
    kinds = [KINDS.get(e[3], -1) for e in events]
    out = [None] * len(events)
    pos = len(events)
    for c in range(len(calls) - 1, -1, -1):
        head, stages = calls[c]
        n = sum(sum(s[1:]) for s in stages)
        if pos < n and c:
            break                   # only the first call can be cut short
        a = max(0, pos - n)
        where = _replay(kinds[a:pos], stages)
        if where is None:
            break
        out[a:pos] = where
        h = min(head, a)
        out[a - h:a] = ["inputs"] * h
        pos = a - h
    return out


def glue_by_stage(view):
    """{stage: glue device us} over the traced calls; None where the
    trace holds no layout (a program without spans). Sets
    ``view.unattributed`` to the (events, glue us) that no call
    accounts for."""
    if not hasattr(view, "_glue_by_stage"):
        out, laid, lost = {}, False, [0, 0.0]
        for events, calls in _segments(view):
            laid |= bool(calls)
            where = _place(events, calls)
            for (name, _, dur, cat), stage in zip(events, where):
                if cat == "kernel" and any(
                        fnmatch.fnmatchcase(bare_name(name), p)
                        for p in view.patterns):
                    continue
                if stage is None:
                    lost[0] += 1
                    lost[1] += dur
                else:
                    out[stage] = out.get(stage, 0.0) + dur
        view.unattributed = tuple(lost)
        if laid and lost[0]:
            print(f"rxbench: {lost[0]} glue events ({lost[1]:.1f} us) of "
                  f"the traced calls fit no stage layout of the program; "
                  f"no glue_<stage>_ms metric counts them", file=sys.stderr)
        view._glue_by_stage = out if laid else None
    return view._glue_by_stage


def read(view, stage):
    """Glue device time per step in ``stage``, in ms; None without
    spans."""
    by = glue_by_stage(view)
    if by is None:
        return None
    return view.per_step_ms(by.get(stage, 0.0))
