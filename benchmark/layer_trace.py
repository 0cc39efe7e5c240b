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

Attribution. Each device operation goes to the innermost span open on the
thread that launched it when its launching runtime call started (matched by
CUPTI correlation id). Operations that overlap count once: each counts from
where the operations started before it ended, so the spans' device times add
up to the device's busy time. A layer's device time is that of its forward
span and its `.bwd` span, with their descendants. Each idle gap between
device operations goes to the span of the operation that ended it: the layer
whose dispatch the device waited for. The route counters' change over a
window is printed beside the launches the trace saw for K1-K3 (the profiler
can miss a launch).
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

# a layer of PERF.md §3 -> the span names whose device time (descendants
# included) is the layer's
LAYERS = {
    "encoder": ("encoder", "encoder.bwd"),
    "hand": ("hand", "hand.bwd"),
    "renderer": ("renderer", "renderer.bwd"),
    "loss": ("loss", "loss.bwd"),
    "ssim": ("loss.ssim", "loss.ssim.bwd"),
    "vgg": ("loss.perceptual", "loss.perceptual.bwd"),
    "optimizer": ("optimizer",),
}
# the layers that with backward's and step's own time make up a step
STEP_PARTS = ("encoder", "hand", "renderer", "loss", "optimizer")
# a route counter -> the kernel names in the trace of the launches it counts
# (K1's zero fill, a memset right before its bin kernel, is counted apart)
ROUTE_KERNELS = {
    "rasterize_msaa.device_launches": ("msaa_bin_kernel", "msaa_fine_kernel"),
    "gather_rows.launches": ("gather_rows_kernel",),
    "scatter_rows.launches": ("scatter_rows_kernel",),
}


def summarize_linked(events) -> dict:
    """tracing.summarize's arrays (device operations and the host's runtime
    calls, each in start order), with each event's correlation id and each
    host call's thread: CUPTI's thread id of a runtime call (Kineto's
    resource id) is its thread's pthread id cut to 32 bits."""
    import torch

    dev, cpu = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        row = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id(), e.device_resource_id())
        (dev if e.device_type() == cuda else cpu).append(row)
    dev.sort(key=lambda r: r[0])
    cpu.sort(key=lambda r: r[0])

    def col(rows, i, dtype):
        return np.array([r[i] for r in rows], dtype)

    return {"dev_start": col(dev, 0, np.int64), "dev_end": col(dev, 1, np.int64), "dev_name": [r[2] for r in dev],
            "dev_corr": col(dev, 3, np.int64), "cpu_start": col(cpu, 0, np.int64), "cpu_end": col(cpu, 1, np.int64),
            "cpu_name": [r[2] for r in cpu], "cpu_corr": col(cpu, 3, np.int64), "cpu_thread": col(cpu, 4, np.int64)}


def thread_key(ident: int) -> int:
    """A span's pthread id as CUPTI records it: its low 32 bits, signed."""
    return (ident + 2**31) % 2**32 - 2**31


def innermost(spans: list, thread: int) -> tuple[np.ndarray, np.ndarray]:
    """(segment starts, the span index innermost in each segment, -1 for
    none) of one thread's spans (by `thread_key`), which nest."""
    ev = []
    for i, s in enumerate(spans):
        if thread_key(s.ident) == thread:
            ev.append((s.start_ns, 1, i))
            ev.append((s.end_ns, 0, -i))  # at one time, ends first, inner spans first
    ev.sort()
    starts, owner, stack = [], [], []
    for k, (t, kind, key) in enumerate(ev):
        if kind:
            stack.append(key)
        else:
            stack.remove(-key)
        if k + 1 == len(ev) or ev[k + 1][0] != t:
            starts.append(t)
            owner.append(stack[-1] if stack else -1)
    return np.array(starts, np.int64), np.array(owner, np.int64)


def owners(summary: dict, spans: list) -> np.ndarray:
    """For each device operation, the index of the span it is attributed to
    (-1 for none): the innermost span open on the thread that launched it
    when its launching runtime call started."""
    n = len(summary["dev_start"])
    out = np.full(n, -1, np.int64)
    corr = summary["cpu_corr"]
    if not n or not len(corr) or not spans:
        return out
    order = np.argsort(corr, kind="stable")
    pos = np.minimum(np.searchsorted(corr[order], summary["dev_corr"]), len(order) - 1)
    call = order[pos]
    linked = (corr[call] == summary["dev_corr"]) & (summary["dev_corr"] != 0)
    at, thread = summary["cpu_start"][call], summary["cpu_thread"][call]
    for tid in {thread_key(s.ident) for s in spans}:
        seg_t, seg_owner = innermost(spans, tid)
        mine = np.nonzero(linked & (thread == tid))[0]
        k = np.searchsorted(seg_t, at[mine], side="right") - 1
        out[mine] = np.where(k >= 0, seg_owner[np.maximum(k, 0)], -1)
    return out


def busy_ns(summary: dict) -> np.ndarray:
    """Each device operation's share of the busy time: its interval less
    what the operations started before it already covered."""
    s, e = summary["dev_start"], summary["dev_end"]
    if not len(s):
        return np.zeros(0, np.int64)
    reach = np.concatenate([s[:1], np.maximum.accumulate(e)[:-1]])
    return np.clip(e - np.maximum(s, reach), 0, None)


def device_ns(summary: dict, spans: list, owner: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(each span's own busy ns, and with its descendants')."""
    dur = busy_ns(summary)
    mine = owner >= 0
    own = np.bincount(owner[mine], weights=dur[mine], minlength=len(spans))
    total = own.copy()
    for i in range(len(spans) - 1, -1, -1):  # a parent opens before its children
        if spans[i].parent is not None:
            total[spans[i].parent] += total[i]
    return own, total


def layer_ms_per_step(spans: list, total: np.ndarray, layer: str) -> float | None:
    """A layer's device ms a step over the window's steps, or None where no
    span of it ran."""
    names = LAYERS[layer]
    steps = sum(s.name == "step" for s in spans)
    picked = [i for i, s in enumerate(spans) if s.name in names]
    if not steps or not picked:
        return None
    return float(total[picked].sum()) / 1e6 / steps


def idle_by_span(summary: dict, spans: list, owner: np.ndarray, top: int = 10) -> list:
    """Idle seconds by the name of the span of the device operation that
    ended each gap (tracing.busy_and_gaps's gaps)."""
    s, e = summary["dev_start"], summary["dev_end"]
    if len(s) < 2:
        return []
    reach = np.maximum.accumulate(e)
    ends = np.nonzero(s[1:] > reach[:-1])[0] + 1  # the operations that end a gap
    by = {}
    for i in ends:
        name = spans[owner[i]].name if owner[i] >= 0 else "(no span)"
        by[name] = by.get(name, 0) + int(s[i] - reach[i - 1])
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


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
    """The window's attribution: per-layer busy ms a step, each span name's
    own busy ms a step, coverage, idle by span."""
    owner = owners(summary, spans)
    own, total = device_ns(summary, spans, owner)
    steps = sum(s.name == "step" for s in spans)
    busy = float(busy_ns(summary).sum())
    by_name = {}
    for i, s in enumerate(spans):
        by_name[s.name] = by_name.get(s.name, 0.0) + own[i]
    in_steps = float(sum(total[i] for i, s in enumerate(spans) if s.name == "step" and s.parent is None))
    bwd = [i for i, s in enumerate(spans) if s.name == "backward" and s.parent is not None
           and spans[s.parent].name == "step"]
    bwd_total = float(total[bwd].sum()) if bwd else 0.0
    bwd_layers = float(sum(total[i] for i, s in enumerate(spans) if s.name.endswith(".bwd")
                           and s.parent is not None and spans[s.parent].name == "backward"))
    layers = {k: layer_ms_per_step(spans, total, k) for k in LAYERS}
    own_ms = {k: v / 1e6 / max(steps, 1) for k, v in by_name.items()}
    parts = sum(layers[k] or 0.0 for k in STEP_PARTS) + own_ms.get("backward", 0.0) + own_ms.get("step", 0.0)
    return {
        "steps": steps,
        "layer_device_ms": layers,
        "own_device_ms": dict(sorted(own_ms.items(), key=lambda kv: -kv[1])),
        "busy_ms_per_step": busy / 1e6 / max(steps, 1),
        "device_ms_per_step": float((summary["dev_end"] - summary["dev_start"]).sum()) / 1e6 / max(steps, 1),
        "step_share_of_busy": in_steps / busy if busy else None,
        "parts_over_busy": parts / (busy / 1e6 / steps) if busy and steps else None,
        "bwd_layer_share": bwd_layers / bwd_total if bwd_total else None,
        "unlinked_ops": int((owner < 0).sum()),
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

    from benchmark import loops, spec, tracing
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
        before = dict(profiling.counters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.spans() as recorded:
                result = run_window(program, pool, args.seconds)
        summary = summarize_linked(prof.profiler.kineto_results.events())
        line = {"window": w, "images_per_s": result["images"] / result["window_s"], "steps": result["steps"],
                "launches_per_step": len(summary["dev_start"]) / result["steps"],
                "breakdown": tracing.breakdown(summary),
                "counters": {k: [profiling.counters[k] - before[k], seen]
                             for k, seen in route_launches_seen(summary).items()}}
        print(json.dumps(line | report(summary, recorded)), flush=True)
        del prof, summary, recorded

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
