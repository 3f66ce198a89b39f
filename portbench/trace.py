"""The traced run's profiler read: a fenced session, its raw events, the
device's busy time over a window, device time inside the benchmark's own
ranges, and the breakdown.

The profiler has been seen to lose the first records of a long process's
session, so every session is fenced: 512 short sleep kernels before the
body and one after; a session whose device events do not begin and end
with a fence did not keep its body, and its reading is dropped. The Python
event list is never built (`RawProfile`): it takes ~0.1 ms an event, and a
rigid MPC period launches ~300k kernels. Spans are the benchmark's own
`record_function` ranges around the calls it makes: inside a replayed CUDA
graph the program's spans do not exist.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

from portbench.common import union_seconds

FENCE, FENCE_PADS, FENCE_WAIT_S = "spin_kernel(", 512, 0.02
WINDOW = "portbench.window"  # the range around the traced calls


class RawProfile(torch.autograd.profiler.profile):
    """The autograd profiler (host and card) with its Python event list left
    empty: the readers take the raw events."""

    def _parse_kineto_results(self, *args, **kwargs):
        return []


@contextlib.contextmanager
def fenced_profile():
    """A profiler session of the card's work and the host's ops around the
    body, fenced; the body runs inside the WINDOW range."""
    torch.cuda.synchronize()
    with RawProfile(use_device="cuda", use_kineto=True, use_cpu=True) as prof:
        for _ in range(FENCE_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(FENCE_WAIT_S)
        with torch.profiler.record_function(WINDOW):
            yield prof
            torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


class Session:
    """A finished session's events: the device's [(start ns, end ns, name)]
    without the fences, the host's ops and the benchmark's ranges."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = prof.kineto_results.events()
        card, self.host, self.ranges = [], [], []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                card.append((start, start + dur, e.name()))
            elif e.is_user_annotation():
                self.ranges.append((start, start + dur, e.name()))
            else:
                self.host.append((start, start + dur, e.name()))
        card.sort()
        self.whole = bool(card) and FENCE in card[0][2] and FENCE in card[-1][2]
        self.card = [c for c in card if FENCE not in c[2]]
        self._starts = [c[0] for c in self.card]
        self._cum = [0]
        for s, e, _ in self.card:
            self._cum.append(self._cum[-1] + (e - s))
        wins = [r for r in self.ranges if r[2] == WINDOW]
        self.window = wins[0][:2] if wins else None

    def named(self, name: str):
        """[(start, end)] of the benchmark's ranges called name."""
        return [(s, e) for s, e, n in self.ranges if n == name]

    def busy_ns(self, start=None, end=None) -> float:
        """ns in which some device operation ran, between start and end."""
        start = self.window[0] if start is None else start
        end = self.window[1] if end is None else end
        return union_seconds([(max(s, start), min(e, end)) for s, e, _ in self.card if e > start and s < end])

    def device_ns_in(self, start, end) -> float:
        """ns of the device operations that started between start and end,
        summed (one stream: no two overlap)."""
        i, j = bisect.bisect_left(self._starts, start), bisect.bisect_left(self._starts, end)
        return float(self._cum[j] - self._cum[i])

    def window_ns(self) -> float:
        return float(self.window[1] - self.window[0])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window summed by the host op that was running (the
        innermost one that began last), each [[name, seconds], ...]."""
        ops = {}
        for s, e, name in self.card:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        busy, gaps, last = sorted((s, e) for s, e, _ in self.card), [], self.window[0]
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.window[1] > last:
            gaps.append((last, self.window[1]))
        host = sorted(self.host + [r for r in self.ranges if r[2] != WINDOW])
        starts = [h[0] for h in host]
        by_host = {}
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            mid = 0.5 * (g0 + g1)
            name = "none"
            for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 400), -1):
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e9
        order = lambda d: sorted(([k[:200], v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(ops), "idle_gaps": order(by_host)}
