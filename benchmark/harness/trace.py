"""Reading a torch.profiler Chrome trace: the device's operations (kernels,
copies, fills) with their intervals, the host's, the union of busy time,
and the longest idle gaps named by what the host was doing in them."""

from __future__ import annotations

import collections
import json

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "fill"}
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")


class Trace:
    def __init__(self, path):
        with open(path) as f:
            events = json.load(f).get("traceEvents", ())
        self.device, self.host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            row = (e.get("name", ""), float(e["ts"]) * 1e-6,
                   float(e["dur"]) * 1e-6)
            if cat in DEVICE_CATS:
                self.device.append((DEVICE_CATS[cat],) + row)
            elif cat in HOST_CATS:
                self.host.append(row)
        self.device.sort(key=lambda r: r[2])
        spans = [(t, t + d) for _, t, d in self.host]
        spans += [(t, t + d) for _, _, t, d in self.device]
        self.start = min(s for s, _ in spans) if spans else 0.0
        self.end = max(e for _, e in spans) if spans else 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self, match=None):
        """[(name, start, dur)] of the kernels whose name ``match`` accepts."""
        return [(n, t, d) for kind, n, t, d in self.device
                if kind == "kernel" and (match is None or match(n))]

    @staticmethod
    def union_s(rows) -> float:
        """Seconds covered by the union of (name, start, dur) intervals."""
        total, cur_s, cur_e = 0.0, None, None
        for _, t, d in sorted(rows, key=lambda r: r[1]):
            if cur_e is None or t > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = t, t + d
            else:
                cur_e = max(cur_e, t + d)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def busy_s(self, kinds=("kernel", "copy", "fill")) -> float:
        return self.union_s([r[1:] for r in self.device if r[0] in kinds])

    def top_ops(self, n=10):
        """The device operations that took most time: [[name, seconds]]."""
        acc = collections.Counter()
        for _, name, _, d in self.device:
            acc[name[:120]] += d
        return [[k, v] for k, v in acc.most_common(n)]

    def idle_gaps(self, n=10):
        """The idle time between kernels, summed by the host operation that
        overlaps each gap most: [[host op, seconds]], longest first."""
        ks = sorted((t, t + d) for kind, _, t, d in self.device
                    if kind == "kernel")
        gaps, end = [], self.start
        for s, e in ks:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.end > end:
            gaps.append((end, self.end))
        host = sorted(self.host, key=lambda r: r[1])
        acc = collections.Counter()
        active, i = [], 0  # host operations that may overlap the gap
        for gs, ge in gaps:
            while i < len(host) and host[i][1] < ge:
                active.append(host[i])
                i += 1
            active = [r for r in active if r[1] + r[2] > gs]
            best, over = "none", 0.0
            for name, t, d in active:
                o = min(ge, t + d) - max(gs, t)
                if o > over:
                    best, over = name, o
            acc[best[:120]] += ge - gs
        return [[k, v] for k, v in acc.most_common(n)]
