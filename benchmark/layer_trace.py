"""Per-layer device time of a cell's train step, from the program's own spans
(hifihr_tpu_torch/utils/profiling.py) on torch.profiler's clock:

    python3 benchmark/layer_trace.py --workload <cell> --seed <n> --seconds <s> [--windows 2]
        [--pairs 12 --chunk 2]

Set-up as run.py's (the cell's pool and program from the seed, the first
steps). Then `--windows` traced windows of `--seconds` each, torch.profiler
(CUDA activity, as run.py's traced run) over each with the program's spans
on: one JSON line per window with the attribution below. Then the spans'
cost: `--pairs` pairs of `--chunk`-second runs of the loop, spans on and off
in turn (on, off, off, on, ...), under the profiler and then without it: one
line each with every chunk's rate. This module imports the port only for
its span switch and counters (`profiling`); the arithmetic reads arrays and
span lists alone.

Attribution is tracing.py's: each device operation to the innermost span
open on its launching thread, overlapping operations counted once, a layer
as its spans with their descendants, each idle gap to the span of the
operation that ended it. The route counters' change over a window is
printed beside the launches the trace saw for K1-K3 (the profiler can miss
a launch).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from benchmark import spec, tracing  # noqa: E402
from benchmark.tracing import busy_ns, device_ns, idle_by_span, owners  # noqa: E402


# a route counter -> the kernel names in the trace of the launches it counts
# (K1's zero fill, a memset right before its bin kernel, is counted apart)
ROUTE_KERNELS = {
    "rasterize_msaa.device_launches": ("msaa_bin_kernel", "msaa_fine_kernel"),
    "gather_rows.launches": ("gather_rows_kernel",),
    "scatter_rows.launches": ("scatter_rows_kernel",),
}


def route_launches_seen(summary: dict) -> dict:
    """The launches of each counted route that the trace holds."""
    names = summary["dev_name"]
    seen = {counter: sum(any(k in name for k in kernels) for name in names)
            for counter, kernels in ROUTE_KERNELS.items()}
    seen["rasterize_msaa.device_launches"] += sum(
        1 for i in range(1, len(names)) if "msaa_bin_kernel" in names[i] and "Memset" in names[i - 1])
    return seen


def top_ops_by_span(summary: dict, spans: list, owner: np.ndarray, top: int = 8) -> list:
    """The device operations that took most time, by name, each with its
    busy seconds split by the span that launched it."""
    dur = busy_ns(summary)
    by_op = {}
    for n, o, d in zip(summary["dev_name"], owner, dur):
        split = by_op.setdefault(n, {})
        name = spans[o].name if o >= 0 else "(no span)"
        split[name] = split.get(name, 0) + int(d)
    first = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:top]
    return [[n[:100], {k: v / 1e9 for k, v in sorted(split.items(), key=lambda kv: -kv[1])}] for n, split in first]


def report(summary: dict, spans: list) -> dict:
    """The window's attribution: tracing.span_summary's (per-layer and each
    span name's own busy ms a step, what the step's parts cover), with the
    step spans' share of busy, the layers' share of the backward, idle by
    span and the top operations by span."""
    owner = owners(summary, spans)
    own, total = device_ns(summary, spans, owner)
    busy = float(busy_ns(summary).sum())
    in_steps = float(sum(total[i] for i, s in enumerate(spans) if s.name == "step" and s.parent is None))
    bwd = [i for i, s in enumerate(spans) if s.name == "backward" and s.parent is not None
           and spans[s.parent].name == "step"]
    bwd_total = float(total[bwd].sum()) if bwd else 0.0
    bwd_layers = float(sum(total[i] for i, s in enumerate(spans) if s.name.endswith(".bwd")
                           and s.parent is not None and spans[s.parent].name == "backward"))
    steps = sum(s.name == "step" for s in spans)
    return {
        "steps": steps,
        **tracing.span_summary(summary, spans, owner, own, total),
        "device_ms_per_step": float((summary["dev_end"] - summary["dev_start"]).sum()) / 1e6 / max(steps, 1),
        "step_share_of_busy": in_steps / busy if busy else None,
        "bwd_layer_share": bwd_layers / bwd_total if bwd_total else None,
        "idle_by_span": idle_by_span(summary, spans, owner),
        "top_ops_by_span": top_ops_by_span(summary, spans, owner),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--chunk", type=float, default=2.0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import loops
    from benchmark.program import build_program
    from benchmark.run import make_pool, power_limit
    from hifihr_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("layer_trace: needs a CUDA card", file=sys.stderr)
        return 2
    first_steps, run_window = loops.LOOPS[cell.traffic["loop"]]
    pool = make_pool(cell, args.seed, "cuda")
    program = build_program(spec.port_config_dict(cell.config), cell.config.get("dataset", "FreiHand"),
                            args.seed, "cuda")
    first_steps(program, pool)
    torch.cuda.synchronize()
    print(json.dumps({"setup_s": time.perf_counter() - T_START, "power_limit": power_limit()}), flush=True)

    for w in range(args.windows):
        result, summary, recorded, counters = tracing.profile_window(
            lambda: run_window(program, pool, args.seconds))
        line = {"window": w, "images_per_s": result["images"] / result["window_s"], "steps": result["steps"],
                "launches_per_step": len(summary["dev_start"]) / result["steps"],
                "breakdown": tracing.breakdown(summary),
                "counters": {k: [counters[k], seen] for k, seen in route_launches_seen(summary).items()}}
        print(json.dumps(line | report(summary, recorded)), flush=True)
        del summary, recorded

    for traced in (True, False) if args.pairs else ():
        rates = []
        with profile(activities=[ProfilerActivity.CUDA]) if traced else contextlib.nullcontext():
            for k in range(2 * args.pairs):
                on = k % 4 in (0, 3)
                with profiling.spans() if on else contextlib.nullcontext():
                    r = run_window(program, pool, args.chunk)
                rates.append((on, r["images"] / r["window_s"]))
        ratios = [(a[1] / b[1]) if a[0] else (b[1] / a[1]) for a, b in zip(rates[0::2], rates[1::2])]
        print(json.dumps({"cost": "traced" if traced else "untraced", "chunk_s": args.chunk,
                          "on_over_off_median": float(np.median(ratios)), "pair_ratios": ratios,
                          "on": [r for o, r in rates if o], "off": [r for o, r in rates if not o]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
