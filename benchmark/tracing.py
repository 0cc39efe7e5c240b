"""The traced run (`--trace 1`): torch.profiler (CUPTI) over the whole
window, the port's kernel entry points wrapped to see their calls, and the
reductions the per-layer readers share.

Wrapped in the traced run only (the untraced run is untouched):
  PhongRenderer.select_faces   K1's scene: the posed mesh and the camera
  render.gather._gather        K2's calls: the table's shape and the row index
  render.gather._scatter       K3's calls: the values' shape, the index, the rows
The wrappers keep references and copy nothing, so they add no device work.

Device time per kernel comes from the trace by kernel name: K1's route is
each `msaa_bin_kernel` with the zero fill (a memset) enqueued right before
it and the `msaa_fine_kernel` after it; K2 is `gather_rows_kernel`; K3 is
`scatter_rows_kernel` with the fill of its zeroed output right before it.
The profiler can miss a launch, so a time per call is a mean over the
launches it saw.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import roofline


@contextlib.contextmanager
def kernel_calls(keep: bool = True):
    """Record K1-K3's calls inside the block (references only); with `keep`
    False record nothing, since the references hold each step's index maps
    alive until the run ends."""
    if not keep:
        yield {}
        return
    from hifihr_tpu_torch.render import gather, renderer

    got = {"K1": [], "K2": [], "K3": []}
    select, k2_fn, k3_fn = renderer.PhongRenderer.select_faces, gather._gather, gather._scatter

    def k1(self, verts_cam, K):
        s = self.settings
        got["K1"].append((verts_cam.detach(), K, self.faces, s.image_size, s.aa_factor))
        return select(self, verts_cam, K)

    def k2(table, idx):
        got["K2"].append((tuple(table.shape), idx))
        return k2_fn(table, idx)

    def k3(values, idx, n_rows):
        got["K3"].append((tuple(values.shape), idx, n_rows))
        return k3_fn(values, idx, n_rows)

    renderer.PhongRenderer.select_faces, gather._gather, gather._scatter = k1, k2, k3
    try:
        yield got
    finally:
        renderer.PhongRenderer.select_faces, gather._gather, gather._scatter = select, k2_fn, k3_fn


def profile_window(window) -> tuple:
    """(window's result, trace summary) of `window()` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    # CUDA activity only: the kernels, copies and memsets, and the host's
    # CUDA runtime calls; recording every aten op as well slowed a step by a third
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        result = window()
    t0 = time.perf_counter()
    summary = summarize(prof.profiler.kineto_results.events())
    summary["reduce_s"] = time.perf_counter() - t0
    return result, summary


def summarize(events) -> dict:
    """Device events and the host's runtime calls as arrays: start and end
    (ns, one clock) and names, each in start order."""
    dev, cpu = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        row = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (dev if e.device_type() == cuda else cpu).append(row)
    dev.sort(key=lambda r: r[0])
    cpu.sort(key=lambda r: r[0])

    def arrays(rows):
        return (np.array([r[0] for r in rows], np.int64), np.array([r[1] for r in rows], np.int64),
                [r[2] for r in rows])

    d0, d1, dn = arrays(dev)
    c0, c1, cn = arrays(cpu)
    return {"dev_start": d0, "dev_end": d1, "dev_name": dn, "cpu_start": c0, "cpu_end": c1, "cpu_name": cn}


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


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps' time by what the host was doing: the host event that began last
    before the device resumed (the one whose work ended the gap)."""
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

    return {"device_ops": first(by_op), "idle_gaps": first(by_host)}


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


def kernel_seconds_per_call(summary: dict, kernel: str) -> float | None:
    if kernel == "K1":
        t_bin, n_bin = _kernel_time(summary, "msaa_bin_kernel", ("Memset",))
        t_fine, n_fine = _kernel_time(summary, "msaa_fine_kernel")
        if not n_bin or not n_fine:
            return None
        return t_bin / n_bin + t_fine / n_fine
    name, before = {"K2": ("gather_rows_kernel", ()), "K3": ("scatter_rows_kernel", ("Fill", "Memset"))}[kernel]
    t, n = _kernel_time(summary, name, before)
    return t / n if n else None


def kernel_bound_seconds(calls: dict, kernel: str) -> float | None:
    """The mean least time of one call of `kernel` over the calls seen."""
    got = calls.get(kernel) or []
    if not got:
        return None
    if kernel == "K1":
        from benchmark.reference.render.raster import project_to_screen
        from benchmark.reference.render.raster_msaa import msaa_prep

        b = [roofline.k1_bound_s(msaa_prep(project_to_screen(v, K), faces)[1], size, samples)
             for v, K, faces, size, samples in got]
    elif kernel == "K2":
        b = [roofline.k2_bound_s(shape, idx) for shape, idx in got]
    else:
        b = [roofline.k3_bound_s(shape, idx, n) for shape, idx, n in got]
    return float(np.mean(b))
