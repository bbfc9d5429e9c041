"""The device trace of a traced run: ``torch.profiler`` over whole units, reduced to what the readers need.

Only the device is traced (CUDA activity): the host is known from the
harness's own spans, laid on the trace's clock by an anchor, the first device
operation after the profiler starts, which the harness launches right after a
synchronize.
"""

import re
import time

PORT = "port"
OTHER = "other"


def short_name(name):
    """A kernel's function name without its namespaces, template arguments and parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    base = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1].strip() or name


class DeviceTrace:
    """Start with ``start()`` after a synchronize, stop with ``stop()`` after one; then ``summary(spans)``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_anchor = self.t_stop = None

    def start(self):
        import torch

        self.prof.start()
        torch.cuda.synchronize()
        self.t_anchor = time.perf_counter()
        torch.zeros(1, device="cuda")  # the anchor: the trace's first device operation

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def device_events(self):
        """[(name, start s, end s)] on the trace's clock, in order of start."""
        from torch.autograd import DeviceType

        events = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in self.prof.events()
                  if e.device_type == DeviceType.CUDA]
        return sorted(events, key=lambda e: e[1])


def summarize(events, t_anchor, t_stop, spans, port_names, top=10):
    """The traced window reduced: busy and window seconds, device time and launches by kernel and by group
    (the port's kernels or other), the top device operations and the longest idle gaps labelled by the
    harness's host span around them.

    ``events`` [(name, start, end)] (seconds, the trace's clock; the first is the anchor), ``t_anchor`` and
    ``t_stop`` the host clock at the anchor and at the end, ``spans`` [(label, host start, host end)].
    """
    if not events:
        return None
    offset = events[0][1] - t_anchor  # trace clock minus host clock
    window = (events[0][1], t_stop + offset)
    kernels = {}
    busy, cur = 0.0, None
    for name, s, e in events[1:]:
        s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        key = short_name(name)
        rec = kernels.setdefault(key, {"launches": 0, "seconds": 0.0, "group": OTHER})
        rec["seconds"] += e - s
        if not key.startswith(("Memcpy", "Memset")):
            rec["launches"] += 1
        if key in port_names:
            rec["group"] = PORT
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += 0.0 if cur is None else cur[1] - cur[0]

    gaps, last = [], window[0]
    for _, s, e in events:
        if s > last:
            gaps.append((s - last, last, s))
        last = max(last, e)
    if window[1] > last:
        gaps.append((window[1] - last, last, window[1]))
    gaps.sort(reverse=True)

    def label(t):
        host = t - offset
        inside = [(e - s, lab) for lab, s, e in spans if s <= host <= e]
        return min(inside)[1] if inside else "harness"

    ops = sorted(((k, v["seconds"]) for k, v in kernels.items()), key=lambda kv: -kv[1])
    return {
        "window_s": window[1] - window[0],
        "busy_s": busy,
        "kernels": kernels,
        "launches": sum(v["launches"] for v in kernels.values()),
        "seconds": {g: sum(v["seconds"] for v in kernels.values() if v["group"] == g) for g in (PORT, OTHER)},
        "breakdown": {"device_ops": [[k, v] for k, v in ops[:top]],
                      "idle_gaps": [[label((s + e) / 2), g] for g, s, e in gaps[:top]]},
    }
