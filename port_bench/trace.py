"""Reading a torch.profiler trace of the measured window.

Device time comes from the profiler's CUDA activity (kernels, copies and
sets, taken from CUPTI; the copies of the host's spans that the profiler
draws on the device's timeline are left out): by kernel name, as a union of intervals (busy),
and as the gaps between them.  A gap is named by what the host was doing:
the shortest host event (an operator, a runtime call or one of the
benchmark's own `port_bench.*` spans) that covers its middle.
"""

from __future__ import annotations

from collections import defaultdict

# The benchmark's own spans, around its calls into the program
WINDOW = "port_bench.window"
REQUEST = "port_bench.request"
EXPORT = "port_bench.export"


def _merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(prof) -> dict:
    """The window's device record: {kernels: {name: s}, busy_s, window_s,
    device_events, device_ops: [[name, s]], idle_gaps: [[name, s]]}.
    The profiler's raw events are read (building its event tree takes
    minutes for a window of a few hundred thousand operators); times in
    its clock (ns) are clipped to the window span."""
    from torch.autograd import DeviceType

    host, device = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b, name = a + e.duration_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("port_bench."):
                device.append((a, b, name))
        else:
            host.append((a, b, name))
            if name == WINDOW:
                window = (a, b)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w0, w1 = window
    kernels: dict[str, float] = defaultdict(float)
    spans = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[name] += (b - a) * 1e-9
        spans.append((a, b))
    busy = _merge(spans)
    busy_ns = sum(b - a for a, b in busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k], edges[k + 1])
                   for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]), reverse=True)[:10]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        cover = [(hb - ha, name) for ha, hb, name in host if ha <= mid <= hb and name != WINDOW]
        idle.append([min(cover)[1] if cover else "host: outside any traced event", length * 1e-9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "kernels": dict(kernels),
        "busy_s": busy_ns * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "device_events": len(spans),
        "device_ops": [[name, s] for name, s in top],
        "idle_gaps": idle,
    }


def kernel_seconds(rec: dict, *parts: str) -> float:
    """Device seconds of the kernels whose name holds any of `parts`."""
    return sum(s for name, s in rec["kernels"].items() if any(p in name for p in parts))
