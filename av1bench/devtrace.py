"""What a traced run reads from the device: the intervals of every kernel,
copy and memset the card ran, from ``torch.profiler``'s CUDA activity,
put on the host's monotonic clock so that the intervals of several
processes can be merged.

Kineto stamps its events on a clock of its own.  ``clock_offset_ns``
reads that clock against ``time.perf_counter_ns`` (CLOCK_MONOTONIC, one
clock for every process of the host) through a marker recorded between
two readings; :class:`DeviceTrace` shifts every interval by it."""

from __future__ import annotations

import time


def clock_offset_ns() -> tuple:
    """(kineto ns - perf_counter ns, uncertainty ns) in this process."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = time.perf_counter_ns()
        with record_function("av1bench.clock"):
            pass
        b = time.perf_counter_ns()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "av1bench.clock"]
    if len(ev) != 1:
        raise RuntimeError("the profiler recorded no clock marker")
    return ev[0].start_ns() - (a + b) // 2, (b - a) // 2


class DeviceTrace:
    """The device's activity between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.offset_ns, self.err_ns = clock_offset_ns()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.events = []

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> list:
        """(start s, end s, name) of each device event, on the
        ``time.perf_counter`` clock."""
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = (e.start_ns() - self.offset_ns) * 1e-9
            out.append((s, s + e.duration_ns() * 1e-9, e.name()))
        self.events = out
        return out


def clip(intervals, t0: float, t1: float) -> list:
    """The parts of ``(start, end, ...)`` intervals inside ``[t0, t1]``."""
    out = []
    for s, e, *rest in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            out.append((s, e, *rest))
    return out


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start, end, ...)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, *_ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summed_s(intervals) -> float:
    """Seconds of the intervals summed (overlaps counted twice)."""
    return sum(e - s for s, e, *_ in intervals)


def base_name(name: str) -> str:
    """A device event's name without its kernel's namespace, template
    arguments, parameters and return type (``void (anonymous
    namespace)::itx_frame_kernel(int const*, ...)`` ->
    ``itx_frame_kernel``); copies and memsets keep their whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    n = name.replace("(anonymous namespace)::", "").split("(")[0]
    depth, out = 0, []
    for ch in n:
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch != ">":
            out.append(ch)
    parts = "".join(out).strip().split(" ")
    return parts[-1] if parts[-1] else name


def by_name(intervals) -> dict:
    """Seconds of device time by event name."""
    out = {}
    for s, e, name in intervals:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def idle_gaps(intervals, t0: float, t1: float, top: int = 10) -> list:
    """The longest stretches of ``[t0, t1]`` in which the device ran
    nothing, each named by the device events around it."""
    gaps, prev_e, prev_n = [], t0, "window start"
    for s, e, name in sorted(intervals):
        if s > prev_e:
            gaps.append((s - prev_e, f"after {base_name(prev_n)} "
                                     f"before {base_name(name)}"))
        if e > prev_e:
            prev_e, prev_n = e, name
    if t1 > prev_e:
        gaps.append((t1 - prev_e, f"after {base_name(prev_n)} "
                                  "before window end"))
    gaps.sort(reverse=True)
    return [[n, g] for g, n in gaps[:top]]
