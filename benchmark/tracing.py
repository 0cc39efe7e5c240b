"""The traced run (`--trace 1`): torch.profiler (CUPTI) over the whole
window with the port's layer spans on, the port's kernel entry points
wrapped to see their calls, and the reductions the per-layer readers share.

Kernels. Each kernel the traced run reads has a file of its own,
kernels/<k>.py, found by the name of the cell's metric <k>_roofline.<...>
(K1: k1_roofline.train, kernels/k1.py); only those a cell reports are
wrapped. A file declares
  WRAPS      the port's function whose calls are the kernel's: (module,
             attribute path), wrapped in the traced run only
  record()   what a call keeps, given the call's arguments: references and
             shapes, nothing copied, so the wrapper adds no device work
  TRACE      the call's kernels by name in the trace, each with the names
             of the operations counted with it where one runs right before
             it (a zero fill)
  bound_s()  a call's least time, from what `record` kept alone
A kernel's time per call is the sum over TRACE of its kernels' mean time a
launch: the profiler can miss a launch, so it is a mean over those it saw.

Spans. The port's spans (hifihr_tpu_torch/utils/profiling.py) are on over
the traced window only; the untraced run is untouched. Each device
operation goes to the innermost span open on the thread that launched it
when its launching runtime call started (matched by CUPTI correlation id;
CUPTI's thread id of a runtime call is its pthread id cut to 32 bits).
Operations that overlap count once: each counts from where the operations
started before it ended, so the spans' device times add up to the device's
busy time. A layer's device time is that of its spans (its forward span and
its `.bwd` span) with their descendants. Each idle gap goes to the span of
the operation that ended it: the layer whose dispatch the device waited for.
"""

from __future__ import annotations

import contextlib
import glob
import importlib
import os
import time

import numpy as np
import torch

from benchmark import spec


# ---------------------------------------------------------------- kernels


def kernel_file(kernel: str, here: str = spec.HERE):
    """kernels/<kernel>.py under `here` (K1: kernels/k1.py)."""
    return spec.load_file(os.path.join(here, "kernels", f"{kernel.lower()}.py"))


def _wrap(kernel, calls: list):
    """Wrap the function `kernel.WRAPS` names so each call appends
    `kernel.record(*args)` to `calls`; returns the undo."""
    module, path = kernel.WRAPS
    *outer, attr = path.split(".")
    owner = importlib.import_module(module)
    for name in outer:
        owner = getattr(owner, name)
    own = vars(owner).get(attr)  # None where the attribute is inherited (a Function's apply)
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        calls.append(kernel.record(*args, **kwargs))
        return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)

    def undo():
        if own is None:
            delattr(owner, attr)
        else:
            setattr(owner, attr, own)

    return undo


def roofline_kernels(per_layer: list) -> list:
    """The kernels whose share of the roofline a cell reports: K1 for a
    metric named k1_roofline.<...>."""
    return sorted({m["name"].split("_roofline.")[0].upper() for m in per_layer if "_roofline." in m["name"]})


@contextlib.contextmanager
def kernel_calls(kernels: list, here: str = spec.HERE):
    """Record the calls of each kernel in `kernels` (by its file) inside the
    block: {kernel: [record, ...]}. Only those are wrapped: a record holds
    its step's index maps alive until the run ends, and a wrapper adds host
    work to the window."""
    got, undo = {}, []
    try:
        for name in kernels:
            got[name] = []
            undo.append(_wrap(kernel_file(name, here), got[name]))
        yield got
    finally:
        for u in reversed(undo):
            u()


def _kernel_time(summary: dict, name: str, before: tuple = ()) -> tuple[float, int]:
    """(seconds of every launch of kernel `name`, with the device operation
    right before each if its name holds one of `before`; launches seen)."""
    names = summary["dev_name"]
    dur = summary["dev_end"] - summary["dev_start"]
    total, n = 0, 0
    for i, k in enumerate(names):
        if name in k:
            total += int(dur[i])
            n += 1
            if i and before and any(b in names[i - 1] for b in before):
                total += int(dur[i - 1])
    return total / 1e9, n


def kernel_seconds_per_call(summary: dict, kernel: str, here: str = spec.HERE) -> float | None:
    """A call's device seconds: each of its kernels' mean time a launch,
    summed; None where one of them was not seen."""
    total = 0.0
    for name, before in kernel_file(kernel, here).TRACE:
        t, n = _kernel_time(summary, name, before)
        if not n:
            return None
        total += t / n
    return total


def kernel_bound_seconds(calls: dict, kernel: str, here: str = spec.HERE) -> float | None:
    """The mean least time of one call of `kernel` over the calls seen."""
    got = calls.get(kernel) or []
    if not got:
        return None
    bound_s = kernel_file(kernel, here).bound_s
    return float(np.mean([bound_s(c) for c in got]))


# ---------------------------------------------------------------- the window


def _port_profiling():
    """(the port's span recorder, its counters); a recorder of no spans
    where the port has none."""
    from hifihr_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None) or (lambda: contextlib.nullcontext([]))
    return spans, getattr(profiling, "counters", {})


def profile_window(window) -> tuple:
    """(window's result, trace summary, the spans recorded, the port's
    counters' change) of `window()` under torch.profiler with the spans on."""
    from torch.profiler import ProfilerActivity, profile

    spans, counters = _port_profiling()
    before = dict(counters)
    # CUDA activity only: the kernels, copies and memsets, and the host's
    # CUDA runtime calls; recording every aten op as well slowed a step by a third
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with spans() as recorded:
            result = window()
    t0 = time.perf_counter()
    summary = summarize(prof.profiler.kineto_results.events())
    summary["reduce_s"] = time.perf_counter() - t0
    return result, summary, list(recorded), {k: v - before.get(k, 0) for k, v in counters.items()}


def summarize(events) -> dict:
    """Device events and the host's runtime calls as arrays, each in start
    order: start and end (ns, one clock), name and correlation id, and each
    host call's thread (CUPTI's, Kineto's resource id)."""
    dev, cpu = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        row = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id(), e.device_resource_id())
        (dev if e.device_type() == cuda else cpu).append(row)
    dev.sort(key=lambda r: r[0])
    cpu.sort(key=lambda r: r[0])

    def col(rows, i):
        return np.array([r[i] for r in rows], np.int64)

    return {"dev_start": col(dev, 0), "dev_end": col(dev, 1), "dev_name": [r[2] for r in dev],
            "dev_corr": col(dev, 3), "cpu_start": col(cpu, 0), "cpu_end": col(cpu, 1),
            "cpu_name": [r[2] for r in cpu], "cpu_corr": col(cpu, 3), "cpu_thread": col(cpu, 4)}


def busy_and_gaps(summary: dict) -> tuple[float, np.ndarray, np.ndarray]:
    """(seconds in which any device operation ran: the union of their
    intervals, the idle gaps' starts and ends in ns)."""
    s, e = summary["dev_start"], summary["dev_end"]
    if not len(s):
        return 0.0, np.zeros(0, np.int64), np.zeros(0, np.int64)
    reach = np.maximum.accumulate(e)
    gap = s[1:] > reach[:-1]
    starts = np.concatenate([s[:1], s[1:][gap]])
    ends = np.concatenate([reach[:-1][gap], reach[-1:]])
    return float((ends - starts).sum()) / 1e9, reach[:-1][gap], s[1:][gap]


def breakdown(summary: dict, spans: list | None = None, owner: np.ndarray | None = None, top: int = 10) -> dict:
    """The device operations that took most time, by name; the idle gaps'
    time by what the host was doing: the host event that began last before
    the device resumed (the one whose work ended the gap); and, given the
    spans and each operation's owner, the idle time by span (idle_by_span)."""
    by_op = {}
    for a, b, n in zip(summary["dev_start"], summary["dev_end"], summary["dev_name"]):
        by_op[n] = by_op.get(n, 0) + int(b - a)
    _, g0, g1 = busy_and_gaps(summary)
    by_host = {}
    if len(g0) and len(summary["cpu_start"]):
        at = np.searchsorted(summary["cpu_start"], g1, side="right") - 1
        for i, a, b in zip(at, g0, g1):
            name = summary["cpu_name"][i] if i >= 0 else "(before the first host event)"
            by_host[name] = by_host.get(name, 0) + int(b - a)

    def first(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    out = {"device_ops": first(by_op), "idle_gaps": first(by_host)}
    if spans:
        out["idle_by_span"] = idle_by_span(summary, spans, owner, top)
    return out


# ---------------------------------------------------------------- spans


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


def layer_ms_per_step(spans: list, total: np.ndarray, names: tuple) -> float | None:
    """The device ms a step of the spans named `names` with their
    descendants, over the window's steps; None where none of them ran."""
    steps = sum(s.name == "step" for s in spans)
    picked = [i for i, s in enumerate(spans) if s.name in names]
    if not steps or not picked:
        return None
    return float(total[picked].sum()) / 1e6 / steps


def idle_by_span(summary: dict, spans: list, owner: np.ndarray, top: int = 10) -> list:
    """Idle seconds by the name of the span of the device operation that
    ended each gap (busy_and_gaps's gaps)."""
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


def attribution(run: dict) -> tuple | None:
    """(each device operation's owner, each span's own and total busy ns)
    of a traced run with spans, worked out once and kept in `run`; None
    where the run has no trace or no spans."""
    if run.get("trace") is None or not run.get("spans"):
        return None
    if "_attribution" not in run:
        owner = owners(run["trace"], run["spans"])
        run["_attribution"] = (owner, *device_ns(run["trace"], run["spans"], owner))
    return run["_attribution"]


# the layers that with backward's and step's own time make up a step
STEP_PARTS = ("encoder", "hand", "renderer", "loss", "optimizer")


def layers(here: str = spec.HERE) -> dict:
    """A layer of PERF.md §3 -> the span names whose device time
    (descendants included) is the layer's: each <layer>_device_ms.train
    metric's SPANS."""
    paths = sorted(glob.glob(os.path.join(here, "metrics", "*_device_ms.train.py")))
    return {os.path.basename(p).split("_device_ms.")[0]: spec.metric_module(os.path.basename(p)[:-3], here).SPANS
            for p in paths}


def span_summary(summary: dict, spans: list, owner: np.ndarray, own: np.ndarray, total: np.ndarray,
                 here: str = spec.HERE) -> dict:
    """The window's reduction by span, a step being a `step` span: busy ms a
    step; each layer's device ms a step; each span name's own device ms a
    step; the share of the busy time that the layers with `backward`'s and
    `step`'s own time hold (about 1 where the spans cover the step); the
    device operations no span holds."""
    steps = max(sum(s.name == "step" for s in spans), 1)
    busy_ms = float(busy_ns(summary).sum()) / 1e6 / steps
    own_ms = {}
    for s, ns in zip(spans, own):
        own_ms[s.name] = own_ms.get(s.name, 0.0) + float(ns) / 1e6 / steps
    by_layer = {k: layer_ms_per_step(spans, total, names) for k, names in layers(here).items()}
    parts = sum(by_layer.get(k) or 0.0 for k in STEP_PARTS) + own_ms.get("backward", 0.0) + own_ms.get("step", 0.0)
    return {"busy_ms_per_step": busy_ms, "layer_device_ms": by_layer,
            "own_device_ms": dict(sorted(own_ms.items(), key=lambda kv: -kv[1])),
            "parts_over_busy": parts / busy_ms if busy_ms else None, "unlinked_ops": int((owner < 0).sum())}
