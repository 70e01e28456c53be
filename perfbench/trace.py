"""The reduction of a ``torch.profiler`` trace to what the per-layer metrics read.

``Trace.of(prof)`` keeps:

- ``ops``: every operation that ran on the card, ``(start, end, name)`` in
  the card's microseconds, sorted: kernels, memsets and copies (the card-side
  copies of the harness's ``record_function`` ranges left out);
- ``ranges``: the harness's host ranges (names starting ``pb.``) by name,
  each ``[(start, end)]`` in the host's microseconds;
- ``attributed``: for each name asked for (``attribute``), the card time of
  the kernels launched from inside the host operations or ranges of that
  name, through the profiler's links from an ATen operation to its kernels;
- ``wall_s``: the traced body's host wall (set by the harness).

Nothing here sets the card's timestamps against the host's but the labels of
the idle gaps in ``breakdown``: in a second profiler session of one process
the card's timestamps were seen to drift from the host's by a tenth within a
second, so the metrics read the card's operations as a whole segment and by
the profiler's links, and set card time against host time only as
durations.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def _is_card(e) -> bool:
    return "CUDA" in str(e.device_type) and not getattr(e, "is_user_annotation", False) \
        and not e.name.startswith("pb.")


def _kernel_us(e) -> float:
    """Card microseconds of the kernels linked to host event ``e`` and to all
    that it encloses."""
    total, todo = 0.0, [e]
    while todo:
        x = todo.pop()
        total += sum(k.duration for k in x.kernels if not k.name.startswith("pb."))
        todo.extend(x.cpu_children)
    return total


def is_kernel(name: str) -> bool:
    """A launched kernel, not a memset or a copy."""
    return not name.startswith(("Memset", "Memcpy"))


class Trace:
    def __init__(self, ops, ranges, host, attributed):
        self.ops: List[Tuple[float, float, str]] = ops
        self.ranges: Dict[str, List[Interval]] = ranges
        self.host: List[Tuple[float, float, str]] = host
        self.attributed: Dict[str, float] = attributed
        self.wall_s: Optional[float] = None

    @classmethod
    def of(cls, prof, window: str = "pb.window", attribute: Sequence[str] = ()) -> "Trace":
        events = prof.events()
        ops, ranges, host = [], defaultdict(list), []
        attributed = {name: 0.0 for name in attribute}
        thread = None
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if _is_card(e):
                ops.append((start, end, e.name))
                continue
            if "CPU" not in str(e.device_type):
                continue
            if e.name.startswith("pb."):
                ranges[e.name].append((start, end))
                if e.name == window:
                    thread = e.thread
            for name in attribute:
                if name in e.name and (e.cpu_parent is None or name not in e.cpu_parent.name):
                    attributed[name] += _kernel_us(e)
        for e in events:
            if "CPU" in str(e.device_type) and e.thread == thread and not _is_card(e):
                host.append((e.time_range.start, e.time_range.end, e.name))
        ops.sort()
        host.sort(key=lambda h: (h[0], -h[1]))
        return cls(ops, {k: sorted(v) for k, v in ranges.items()}, host, attributed)

    # ------------------------------------------------------------------
    def busy_intervals(self) -> List[Interval]:
        """The union of the operations' intervals."""
        out: List[Interval] = []
        for s, e, _ in self.ops:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> List[Interval]:
        """The stretches with nothing running on the card, between its first
        operation and its last."""
        b = self.busy_intervals()
        return [(x[1], y[0]) for x, y in zip(b, b[1:]) if y[0] > x[1]]

    def host_labels(self, points: Iterable[float]) -> List[str]:
        """For each of the sorted host times ``points``: the innermost ``pb.``
        range and host operation of the window's thread that hold it."""
        labels, stack, i = [], [], 0
        for m in points:
            while i < len(self.host) and self.host[i][0] <= m:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            pb = next((h[2] for h in reversed(stack) if h[2].startswith("pb.")), "outside")
            op = stack[-1][2] if stack and not stack[-1][2].startswith("pb.") else "python"
            labels.append(f"{pb} / {op}")
        return labels

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The card operations that took most time, and the idle gaps between
        the card's operations by what the host was doing at their midpoints
        (the card's timestamps set against the host's), each in seconds, at
        most ``top`` each."""
        by_op: Dict[str, float] = defaultdict(float)
        for s, e, name in self.ops:
            by_op[name[:120]] += (e - s) / 1e6
        gaps = self.gaps()
        by_host: Dict[str, float] = defaultdict(float)
        for (s, e), label in zip(gaps, self.host_labels([(s + e) / 2 for s, e in gaps])):
            by_host[label] += (e - s) / 1e6
        order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(by_op), "idle_gaps": order(by_host)}
