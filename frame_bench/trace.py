"""The reduction of one ``torch.profiler`` trace (its Chrome trace events)
to what the metrics read: the device's operations and the host's calls
inside the traced window, the device's busy time as the union of its
operations' intervals, and the idle gaps by what the host was doing.

Kernel and copy events carry the device's timestamps, which the profiler
has put on the host's timeline, so one window (the ``frame_bench.window``
range) bounds both. Microseconds in, seconds out.
"""

from __future__ import annotations

from collections import defaultdict

# The device's operations: kernels (a graph's replay traces each of its
# kernels), copies and sets.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The host's CUDA calls that issue device work (kernel and graph launches,
# copies, sets), as the profiler names them; ``profiling.LAUNCH_CALLS`` of
# the port's ``bench/profiling.py``, copied.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
# Host events that can label an idle gap: the harness's ranges, torch ops
# and CUDA calls.
LABEL_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out = []
    at = lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """The traced window of a Chrome trace's ``events`` (a dict with
    ``traceEvents`` or a list), bounded by the range named ``window``."""

    def __init__(self, events, window):
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        spans = [e for e in events
                 if e.get("ph") == "X" and "dur" in e and "ts" in e]
        win = [e for e in spans
               if e["name"] == window and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"no {window!r} range in the trace")
        self.lo = float(win[0]["ts"])
        self.hi = self.lo + float(win[0]["dur"])

        def inside(e):
            return self.lo <= float(e["ts"]) < self.hi

        self.device = [(e["name"], float(e["ts"]),
                        min(float(e["ts"]) + float(e["dur"]), self.hi))
                       for e in spans
                       if e.get("cat") in DEVICE_CATS and inside(e)]
        self.calls = [e["name"] for e in spans
                      if e.get("cat") in HOST_CATS and inside(e)
                      and e["name"].startswith(LAUNCH_CALLS)]
        self.labels = [(e["name"], float(e["ts"]),
                        float(e["ts"]) + float(e["dur"]))
                       for e in spans
                       if e.get("cat") in LABEL_CATS and inside(e)
                       and e["name"] != window]

    def window_s(self):
        return (self.hi - self.lo) / 1e6

    def busy_s(self):
        return union_length([(s, e) for _, s, e in self.device]) / 1e6

    def device_seconds(self, substrings=None):
        """Seconds of the device operations whose names hold any of
        ``substrings`` (all of them with None), and their count."""
        sel = [(s, e) for name, s, e in self.device
               if substrings is None or any(k in name for k in substrings)]
        return sum(e - s for s, e in sel) / 1e6, len(sel)

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        summed by the innermost host event under each gap's midpoint
        (``idle`` where none), each as [name, seconds], longest first."""
        by_op = defaultdict(float)
        for name, s, e in self.device:
            by_op[name] += (e - s) / 1e6
        by_gap = defaultdict(float)
        for s, e in gaps([(s, e) for _, s, e in self.device], self.lo,
                         self.hi):
            mid = 0.5 * (s + e)
            under = [(le - ls, name) for name, ls, le in self.labels
                     if ls <= mid < le]
            by_gap[min(under)[1] if under else "idle"] += (e - s) / 1e6

        def top_of(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_gap)}
