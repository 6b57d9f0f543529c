"""One run of one cell: set-up, the measured window, the trace, the judge.

The loop is closed, with one client: a request is sent when the one before
it has finished, from the start of the window until `seconds` have passed;
the window ends when the last request sent in it finishes, so every
request counts and so does all of the window's time.  Each request's
inputs derive from --seed and its counter; set-up warms up requests of the
same shapes with seeds of their own (the mix's `warm_up`, by default 2).
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import statistics
import sys
import tempfile
import time
import traceback

from . import spec as SP
from . import trace as TR

WARM_UP = 2  # requests before the window, counters -1, -2, ..., unless the mix sets warm_up


def derive(seed: int, label: str, i: int, bits: int = 64) -> int:
    """A number of `bits` bits from --seed, a label and a request counter."""
    h = hashlib.sha256(f"{seed}/{label}/{i}".encode()).digest()
    return int.from_bytes(h, "little") >> (256 - bits)


def quantiles_ms(seconds: list[float]) -> dict:
    """The 50th and 90th percentiles, in ms (statistics.quantiles,
    exclusive method; one sample stands for every percentile)."""
    if len(seconds) == 1:
        return {50: seconds[0] * 1e3, 90: seconds[0] * 1e3}
    q = statistics.quantiles(seconds, n=10)
    return {50: q[4] * 1e3, 90: q[8] * 1e3}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: SP.Spec, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result line of one run (without the check for banned modules,
    which main() makes once this returns).  t_start: the host clock when
    the process started its set-up."""
    import torch

    with tempfile.TemporaryDirectory(prefix="port_bench-") as tmp:
        client = SP.request_kind(spec.traffic["request"]).Client(spec, seed, device, tmp)
        client.setup()
        for k in range(1, int(spec.traffic.get("warm_up", WARM_UP)) + 1):
            client.request(-k)
        _sync(device)
        client.begin()
        cuda = torch.device(device).type == "cuda"
        setup_s = time.perf_counter() - t_start

        latencies: list[float] = []
        failed = 0
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import ProfilerActivity, profile

                prof = stack.enter_context(
                    profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            stack.enter_context(torch.profiler.record_function(TR.WINDOW))
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            while True:
                a = time.perf_counter()
                try:
                    with torch.profiler.record_function(TR.REQUEST):
                        out = client.request(i)
                        _sync(device)
                    latencies.append(time.perf_counter() - a)
                    client.done(i, out)
                except Exception:  # a request that fails is counted, and the window goes on
                    traceback.print_exc(file=sys.stderr)
                    failed += 1
                i += 1
                if time.perf_counter() >= deadline:
                    break
            window_s = time.perf_counter() - t0
        attempted = i
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}}
        units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
        if trace:
            rec = TR.read(prof)
            del prof
            rec.update(client.layer_record(len(latencies)))
            rec["config"], rec["traffic"] = spec.config, spec.traffic
            for m in spec.per_layer:
                v = spec.readers[m["name"]](rec) if latencies else None
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v, "unit": units[m["name"]]}
        elif latencies:
            for name, v in client.end_to_end(window_s, latencies).items():
                result["metrics"][name] = {"value": v, "unit": units[name]}
            result["metrics"]["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": spec.chips,
            "memory_peak_bytes": peak,
        }
        if trace:
            result["device"]["busy_s"] = rec["busy_s"]
            result["device"]["window_s"] = rec["window_s"]
            result["breakdown"] = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}

        if cuda:
            torch.cuda.empty_cache()
        checks = {}
        t_judge = time.perf_counter()
        if latencies:
            try:
                checks = client.check(random.Random(derive(seed, "judge", 0)))
            except Exception:  # outputs the judge cannot read are not correct
                traceback.print_exc(file=sys.stderr)
                checks = {"judge_errors": (1, 0)}
        result["correct"] = bool(checks) and failed == 0 and all(
            v <= lim for v, lim in checks.values())
        result["judge_s"] = time.perf_counter() - t_judge
        result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
        return result
