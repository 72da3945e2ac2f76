"""The traced run's device timeline: ``torch.profiler`` over a bounded
sample of calls spread over the window, reduced to what the per-layer
metrics read.

``Segments`` decides when a segment is due (``segments`` of them, centred
in equal parts of the window), profiles ``calls`` consecutive calls each
(the loop drains the pipeline before and after, so a segment holds whole
calls), and parses each segment's Chrome trace: device kernels, copies and
fills, and the host's activities (to name the device's idle gaps).

``TraceView`` is what a metric reads: device time by kernel name pattern,
the union of device busy time, the traced span, the steps profiled, and
the copies from the device to pinned host memory.
"""

import fnmatch
import json
import os
import re

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function"}


def bare_name(name):
    """A kernel's function name without return type, namespaces, template
    arguments or parameters: ``void (anonymous namespace)::
    ldpc_layered_kernel<21, false>(...)`` -> ``ldpc_layered_kernel``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    name = re.sub(r"^void\s+", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name.rsplit("::", 1)[-1]


def parse_trace(path):
    """A Chrome trace -> (device events [(name, start_us, dur_us, cat)],
    host events [(name, start_us, dur_us)])."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((e["name"], ts, dur, cat))
        elif cat in HOST_CATS:
            host.append((e["name"], ts, dur))
    return dev, host


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals):
    """The idle gaps between the union's pieces: [(start, end)]."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


class Segments:
    def __init__(self, segments, calls, path):
        self.segments = segments
        self.due_at = []
        self.calls = calls
        self.path = path
        self.prof = None
        self.left = 0
        self.parsed = []            # (device events, host events, steps)

    def schedule(self, t0, seconds):
        """Centre the segments in equal parts of the window."""
        self.due_at = [t0 + (k + 0.5) * seconds / self.segments
                       for k in range(self.segments)]

    def due(self, now):
        return self.prof is None and bool(self.due_at) and \
            now >= self.due_at[0]

    @property
    def active(self):
        return self.prof is not None

    @staticmethod
    def _profile():
        import torch

        return torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def warm(self, fn):
        """Profile ``fn`` once and drop the trace: the profiler's first
        start (the device tracer's set-up, seconds) then falls in the
        run's set-up and not inside a segment."""
        prof = self._profile()
        prof.start()
        fn()
        prof.stop()

    def start(self):
        self.due_at.pop(0)
        self.prof = self._profile()
        self.prof.start()
        self.left = self.calls
        self.indexes = []

    def count(self, index):
        """A call was submitted inside the segment; True when it was the
        segment's last."""
        self.indexes.append(index)
        self.left -= 1
        return self.left == 0

    def stop(self, steps_per_call):
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        dev, host = parse_trace(self.path)
        os.remove(self.path)
        self.parsed.append((dev, host, len(self.indexes) * steps_per_call,
                            list(self.indexes)))


class TraceView:
    """What the per-layer metrics read, over every profiled segment."""

    def __init__(self, parsed, patterns, geometry, counters, peaks):
        self.device, self.host, self.spans, self.busy = [], [], [], []
        self.steps = 0
        self.gaps = []
        for dev, host, steps, _ in parsed:
            if not dev:
                continue
            iv = [(s, s + d) for _, s, d, _ in dev]
            t0, t1 = min(s for s, _ in iv), max(e for _, e in iv)
            self.spans.append(t1 - t0)
            self.busy.append(union_us(iv))
            self.device += dev
            self.host += host
            self.steps += steps
            self.gaps += [(a, b, host) for a, b in gaps(iv)]
        self.patterns = patterns        # every layer metric's patterns
        self.geometry = geometry
        self.counters = counters
        self.peaks = peaks

    @property
    def span_us(self):
        return sum(self.spans)

    @property
    def busy_us(self):
        return sum(self.busy)

    def kernel_us(self, patterns):
        """Device time of the kernels whose bare name matches a pattern."""
        return sum(d for n, _, d, cat in self.device if cat == "kernel"
                   and any(fnmatch.fnmatchcase(bare_name(n), p)
                           for p in patterns))

    def dtoh_us(self):
        return sum(d for n, _, d, cat in self.device
                   if cat == "gpu_memcpy" and "DtoH" in n)

    def unmatched_us(self):
        """Device time no layer's patterns claim, copies to the host
        aside: the step's glue."""
        total = 0.0
        for n, _, d, cat in self.device:
            if cat == "gpu_memcpy" and "DtoH" in n:
                continue
            if cat == "kernel" and any(
                    fnmatch.fnmatchcase(bare_name(n), p)
                    for p in self.patterns):
                continue
            total += d
        return total

    def per_step_ms(self, us):
        return us / self.steps / 1e3 if self.steps else None

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps named by what the host was doing in their middle."""
        by = {}
        for n, _, d, cat in self.device:
            key = bare_name(n) if cat == "kernel" else n
            by[key] = by.get(key, 0.0) + d
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        idle = []
        for a, b, host in longest:
            mid = 0.5 * (a + b)
            around = [(d, n) for n, s, d in host if s <= mid <= s + d]
            idle.append([min(around)[1] if around else "no host activity",
                         (b - a) / 1e6])
        return {"device_ops": [[k, v / 1e6] for k, v in ops],
                "idle_gaps": idle}

