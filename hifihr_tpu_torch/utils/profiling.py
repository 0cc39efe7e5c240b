"""Spans and counters at the port's layer boundaries, and the operator's
trace (counterpart of hifihr_tpu/utils/profiling.py).

Spans. `with spans() as recorded:` switches the span sites on for the
block and fills `recorded` with one `Span` per site passed, handed out when
the block ends. A site is

    with span("renderer", inputs) as sp:
        ...
        sp.outputs(rgba)

and records its name, start and end on the clock torch.profiler stamps its
host events with (Unix nanoseconds, `time.time_ns`), its parent (the span
open on the same thread, or, on a thread with no span open, the innermost
span open on the thread that opened the block), its thread (the OS id and
the pthread id, `threading.get_ident`, which CUPTI's records of the CUDA
runtime calls carry cut to 32 bits) and the step id (`span("step",
new_step=True)` starts a step; every span opened until the next one
carries its id). Outside the block a site costs one check of the module
flag `_recorder` and enters a shared no-op context: no hook is registered
and no tensor is touched.

Backward spans. The autograd engine runs the backward of CUDA tensors on a
thread of its own, so a forward span's backward is recorded as
`<name>.bwd`, opened and closed from hooks on autograd nodes, registered
while spans are on: opened when the first producer of the span's outputs
is about to run, closed when the producer of one of the span's inputs
(tensors with a producer; parameters are not inputs) is. The engine runs
the graph's nodes in reverse creation order (its ready queue takes the
latest-created node first), so a span's backward nodes run together, and
the latest-created producer of its inputs runs right after the span's
first-created node; only it and the one before it get a closing hook.
Opening a `.bwd` span closes the open `.bwd` spans of its thread that do
not belong to one of its forward ancestors (their backward is over). A `.bwd` span whose inputs have no producer (the
encoder's, over the images) closes with the span open on the recording
thread that it hangs under. On a thread other than the recording one, the
first span opened hangs under a continuation of the recording thread's
innermost span, of the same name and closed with it, so what that thread
launches outside a layer's `.bwd` span counts to `backward`.

Counters. `counters` holds the kernel routes' launch counts and two counts of
the SSAA render's work, always on (one integer add a call):
  rasterize_msaa.launches             K1 routes (one per call on a CUDA tensor)
  rasterize_msaa.device_launches      K1 launches, as the C route counts them
  rasterize_face_id.launches          K4 routes
  rasterize_face_id.device_launches   K4 launches, as the C route counts them
  gather_rows.launches                K2 launches
  scatter_rows.launches               K3 launches (gather_rows' backward too)
  ssim.launches                       K5 launches (losses/ssim.py: two a forward, one a backward)
  sample_texture.launches             render/texture.py::sample_texture calls, each one K2 fetch of
                                      texel quads (on the CPU too: two an SSAA train step on the
                                      CPU, the shade and its recompute; none in SSAA on the card)
  ssaa_shade.recomputes               recomputes of the SSAA shade pass in backward (one an SSAA
                                      train step on the CPU; none on the card, where K6 recomputes
                                      each fragment in its backward launch)
  ssaa_shade.kernel_launches          K6 launches (render/ssaa_shade.py: one a forward, one a
                                      backward; two an SSAA train step on the card, one an eval)

Trace. `trace(log_dir)` runs torch.profiler (CPU activity, and CUDA
activity where there is a card) with the spans on over the block and writes
a Chrome / TensorBoard trace (`<host>_<pid>.<ns>.pt.trace.json`) into
`log_dir` when the block ends, each span a complete event on its thread's
row, beside the operators, the runtime calls and the kernels they launched.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from dataclasses import dataclass

import torch

counters = dict.fromkeys(("rasterize_msaa.launches", "rasterize_msaa.device_launches",
                          "rasterize_face_id.launches", "rasterize_face_id.device_launches",
                          "gather_rows.launches", "scatter_rows.launches", "ssim.launches",
                          "sample_texture.launches", "ssaa_shade.recomputes",
                          "ssaa_shade.kernel_launches"), 0)


@dataclass(frozen=True)
class Span:
    name: str
    start_ns: int  # Unix ns, the clock of torch.profiler's host events
    end_ns: int
    parent: int | None  # index of the parent span in the recorded list
    thread: int  # OS thread id (threading.get_native_id)
    ident: int  # pthread id (threading.get_ident)
    step: int | None  # id of the step the span belongs to


# the open recording, or None: the flag every span site checks
_recorder = None

# fields of a span while it is recorded (a list, since its end comes later)
_NAME, _START, _END, _PARENT, _THREAD, _STEP, _FWD, _IDENT = range(8)


class _Recorder:
    def __init__(self):
        self.rows = []
        self.stacks = {}  # OS thread id -> indices of its open spans, innermost last
        self.home = threading.get_native_id()
        self.step = None
        self.lock = threading.Lock()

    def open(self, name: str, fwd: int | None = None, new_step: bool = False) -> int:
        """Open a span on the calling thread; `fwd` is the forward span of
        a `.bwd` span. Returns its index."""
        t = time.time_ns()
        tid = threading.get_native_id()
        with self.lock:
            if new_step:
                self.step = 0 if self.step is None else self.step + 1
            stack = self.stacks.setdefault(tid, [])
            if fwd is not None:
                while stack and self.rows[stack[-1]][_FWD] is not None and \
                        not self._encloses(self.rows[stack[-1]][_FWD], fwd):
                    self._close_top(stack, t)
            if not stack and tid != self.home and self.stacks.get(self.home):
                home = self.stacks[self.home][-1]
                stack.append(self._row(self.rows[home][_NAME], t, home, tid, None))
            return self._push(stack, name, t, tid, fwd)

    def close(self, index: int) -> None:
        """Close span `index` and what is open above it on its thread (and,
        on other threads, under any of them)."""
        t = time.time_ns()
        with self.lock:
            row = self.rows[index]
            if row[_END] is None:
                stack = self.stacks[row[_THREAD]]
                while stack[-1] != index:
                    self._close_top(stack, t)
                self._close_top(stack, t)

    def finish(self) -> list[Span]:
        t = time.time_ns()
        with self.lock:
            for stack in self.stacks.values():
                while stack:
                    self._close_top(stack, t)
        return [Span(r[_NAME], r[_START], r[_END], r[_PARENT], r[_THREAD], r[_IDENT], r[_STEP]) for r in self.rows]

    def _encloses(self, outer: int, inner: int) -> bool:
        """Whether forward span `outer` is `inner` or one of its ancestors."""
        while inner is not None:
            if inner == outer:
                return True
            inner = self.rows[inner][_PARENT]
        return False

    def _row(self, name, t, parent, tid, fwd) -> int:
        self.rows.append([name, t, None, parent, tid, self.step, fwd, threading.get_ident()])
        return len(self.rows) - 1

    def _push(self, stack, name, t, tid, fwd) -> int:
        i = self._row(name, t, stack[-1] if stack else None, tid, fwd)
        stack.append(i)
        return i

    def _close_top(self, stack, t) -> None:
        i = stack.pop()
        self.rows[i][_END] = t
        for other in self.stacks.values():
            if other and other is not stack and self.rows[other[0]][_PARENT] == i:
                while other:
                    self._close_top(other, t)


def _grad_tensors(tree, out: list) -> list:
    """The tensors of a nested dict / list / tuple that have a producer in
    the autograd graph."""
    if isinstance(tree, torch.Tensor):
        if tree.grad_fn is not None:
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _grad_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _grad_tensors(v, out)
    return out


def _producers(tree) -> dict:
    """The distinct autograd nodes that produced the tensors of a nested
    dict / list / tuple, by sequence number (creation order on a thread)."""
    return {t.grad_fn._sequence_nr(): t.grad_fn for t in _grad_tensors(tree, [])}


# the inputs' latest-created producers that get a closing hook: the first
# to run ends the span's backward; the second stands in for a first that the
# backward does not reach
CLOSING_NODES = 2


class _Span:
    """An open forward span: records itself, and with grad on registers
    the node hooks that open and close its `.bwd` span."""

    def __init__(self, rec: _Recorder, name: str, inputs, new_step: bool):
        self.rec, self.name = rec, name
        self.index = rec.open(name, new_step=new_step)
        # taken now (a dict of inputs may gain the span's outputs), and held
        # only until the hooks are registered: a hook that held the nodes
        # would keep them alive with the graph
        self.inputs = _producers(inputs) if torch.is_grad_enabled() else {}
        self.bwd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.inputs = None
        self.rec.close(self.index)
        return False

    def outputs(self, *trees) -> None:
        """Declare the tensors the span hands on that the backward reaches
        (nested dicts, lists and tuples): the first of their producers to
        run opens `<name>.bwd`."""
        inputs, self.inputs = self.inputs, None
        if not torch.is_grad_enabled():
            return
        outs = [n for k, n in _producers(trees).items() if k not in inputs]
        if not outs:
            return
        for n in outs:
            n.register_prehook(self._open_bwd)
        for k in sorted(inputs, reverse=True)[:CLOSING_NODES]:
            inputs[k].register_prehook(self._close_bwd)

    def _open_bwd(self, grads):
        if self.bwd is None and self.rec is _recorder:
            self.bwd = self.rec.open(self.name + ".bwd", fwd=self.index)

    def _close_bwd(self, grads):
        if self.bwd is not None and self.rec is _recorder:
            self.rec.close(self.bwd)


class _Off:
    """The shared span of a site while spans are off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def outputs(self, *trees) -> None:
        pass


_OFF = _Off()


def span(name: str, inputs=None, new_step: bool = False):
    """A span site: `inputs` are the tensors (nested dicts, lists, tuples)
    the span's work reads; `new_step` starts a new step id."""
    if _recorder is None:
        return _OFF
    return _Span(_recorder, name, inputs, new_step)


@contextlib.contextmanager
def spans():
    """Record every span site passed inside the block; yields the list,
    filled with `Span`s when the block ends. Blocks do not nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans() is already recording")
    rec = _Recorder()
    recorded = []
    _recorder = rec
    try:
        yield recorded
    finally:
        _recorder = None
        recorded.extend(rec.finish())


def _chrome_events(recorded: list[Span], base_ns: int) -> list[dict]:
    """The spans as Chrome trace complete events (µs after `base_ns`)."""
    return [{"ph": "X", "cat": "span", "name": s.name, "pid": os.getpid(), "tid": s.thread,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"step": s.step, "parent": s.parent, "index": i}} for i, s in enumerate(recorded)]


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    recorded = []

    def write(prof):
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"].extend(_chrome_events(recorded, int(doc.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as f:
            json.dump(doc, f)

    with profile(activities=activities, on_trace_ready=write) as prof:
        with spans() as recorded:
            yield prof
