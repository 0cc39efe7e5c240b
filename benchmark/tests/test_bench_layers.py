"""The spans' attribution (tracing.py) on made-up traces: device operations
to the innermost span open on their launching thread, matched by
correlation id; idle gaps to the span of the operation that ended them; a
layer's device ms a step, as layer_trace.py reports it and as each layer
metric of the traced run reads it; nothing read where the run has no
spans."""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import pytest

from benchmark import layer_trace, spec, tracing

Span = namedtuple("Span", "name start_ns end_ns parent thread ident step")
# pthread ids; CUPTI records a runtime call's thread as the low 32 bits, signed
MAIN, AUTOGRAD = 139771681891072, 139757617149632
MAIN32, AUTOGRAD32 = 561177344, -618662208


def summary(dev: list, calls: list) -> dict:
    """dev: (start, end, name, corr); calls: (start, end, name, corr, thread)."""
    dev, calls = sorted(dev), sorted(calls)
    return {"dev_start": np.array([d[0] for d in dev], np.int64), "dev_end": np.array([d[1] for d in dev], np.int64),
            "dev_name": [d[2] for d in dev], "dev_corr": np.array([d[3] for d in dev], np.int64),
            "cpu_start": np.array([c[0] for c in calls], np.int64),
            "cpu_end": np.array([c[1] for c in calls], np.int64), "cpu_name": [c[2] for c in calls],
            "cpu_corr": np.array([c[3] for c in calls], np.int64),
            "cpu_thread": np.array([c[4] for c in calls], np.int64)}


# one step: the forward on the main thread, the backward launched from the
# autograd thread under a continuation of `backward`, then the optimizer
SPANS = [
    Span("step", 0, 1000, None, 0, MAIN, 0),  # 0
    Span("encoder", 10, 100, 0, 0, MAIN, 0),  # 1
    Span("loss", 100, 300, 0, 0, MAIN, 0),  # 2
    Span("loss.ssim", 150, 250, 2, 0, MAIN, 0),  # 3
    Span("backward", 300, 800, 0, 0, MAIN, 0),  # 4
    Span("backward", 310, 800, 4, 0, AUTOGRAD, 0),  # 5: the continuation
    Span("loss.bwd", 310, 500, 5, 0, AUTOGRAD, 0),  # 6
    Span("loss.ssim.bwd", 320, 400, 6, 0, AUTOGRAD, 0),  # 7
    Span("encoder.bwd", 600, 800, 5, 0, AUTOGRAD, 0),  # 8
    Span("optimizer", 800, 900, 0, 0, MAIN, 0),  # 9
]


def step_trace():
    calls = [(20, 25, "cudaLaunchKernel", 1, MAIN32), (160, 165, "cudaLaunchKernel", 2, MAIN32),
             (260, 262, "cudaLaunchKernel", 3, MAIN32), (330, 335, "cudaLaunchKernel", 4, AUTOGRAD32),
             (450, 455, "cudaLaunchKernel", 5, AUTOGRAD32), (520, 525, "cudaLaunchKernel", 6, AUTOGRAD32),
             (610, 615, "cudaLaunchKernel", 7, AUTOGRAD32), (301, 302, "cudaMemsetAsync", 8, MAIN32),
             (810, 815, "cudaLaunchKernel", 9, MAIN32), (950, 951, "cudaLaunchKernel", 10, MAIN32)]
    # each op runs some time after its launch; "stray" has no runtime call
    # in the trace (correlation id 0)
    dev = [(30, 60, "conv", 1), (170, 200, "ssim_conv", 2), (270, 280, "add_loss", 3), (340, 370, "dgrad", 4),
           (460, 470, "mul", 5), (530, 535, "add_between", 6), (620, 700, "conv_bwd", 7),
           (303, 304, "Memset", 8), (820, 840, "adam", 9), (960, 961, "copy", 10), (1, 2, "stray", 0)]
    return summary(dev, calls)


def test_ops_go_to_the_innermost_span_on_their_launching_thread():
    t = step_trace()
    owner = tracing.owners(t, SPANS)
    got = {t["dev_name"][i]: (SPANS[o].name if o >= 0 else None) for i, o in enumerate(owner)}
    # dgrad was launched from the autograd thread at 330, while the main
    # thread sat in `backward`: it goes to loss.ssim.bwd; add_between was
    # launched from the autograd thread between two layers' .bwd spans: the
    # continuation's own time
    assert got == {"conv": "encoder", "ssim_conv": "loss.ssim", "add_loss": "loss", "dgrad": "loss.ssim.bwd",
                   "mul": "loss.bwd", "add_between": "backward", "conv_bwd": "encoder.bwd",
                   "Memset": "backward", "adam": "optimizer", "copy": "step", "stray": None}
    own, total = tracing.device_ns(t, SPANS, owner)
    assert own[5] == 5 and own[4] == 1  # the continuation's add, the main thread's memset
    assert total[0] == 217  # every op but the stray one
    assert total[2] == 40 and total[6] == 40 and total[4] == 126


def test_thread_key_is_cuptis_32_bit_thread_id():
    assert [tracing.thread_key(t) for t in (MAIN, AUTOGRAD, 5)] == [MAIN32, AUTOGRAD32, 5]


def test_a_call_on_one_thread_never_goes_to_a_span_of_another():
    spans = [Span("step", 0, 100, None, 0, MAIN, 0), Span("loss.bwd", 0, 100, None, 0, AUTOGRAD, 0)]
    t = summary([(50, 60, "k", 7)], [(40, 41, "cudaLaunchKernel", 7, MAIN32)])
    assert tracing.owners(t, spans).tolist() == [0]
    t = summary([(50, 60, "k", 7)], [(40, 41, "cudaLaunchKernel", 7, 33)])  # a thread with no span
    assert tracing.owners(t, spans).tolist() == [-1]


def test_layer_ms_per_step_counts_forward_backward_and_their_children():
    t = step_trace()
    _, total = tracing.device_ns(t, SPANS, tracing.owners(t, SPANS))
    ms = {k: tracing.layer_ms_per_step(SPANS, total, names) for k, names in tracing.layers().items()}
    assert ms["encoder"] == pytest.approx((30 + 80) / 1e6)
    assert ms["loss"] == pytest.approx((10 + 30 + 10 + 30) / 1e6)
    assert ms["ssim"] == pytest.approx((30 + 30) / 1e6)
    assert ms["optimizer"] == pytest.approx(20 / 1e6)
    assert ms["hand"] is None and ms["vgg"] is None  # no span of theirs ran
    r = layer_trace.report(t, SPANS)
    assert r["steps"] == 1 and r["layer_device_ms"] == ms and r["unlinked_ops"] == 1
    assert r["step_share_of_busy"] == pytest.approx(217 / 218)
    assert r["bwd_layer_share"] == pytest.approx(120 / 126)  # loss.bwd and encoder.bwd of backward's 126
    # the layers, backward's own (1 + 5) and step's own (1) make up the step's 217 of device time
    assert sum(r["own_device_ms"].values()) * 1e6 == pytest.approx(217)
    assert r["parts_over_busy"] == pytest.approx(217 / 218) and r["busy_ms_per_step"] == pytest.approx(218 / 1e6)


def test_idle_gaps_go_to_the_span_of_the_op_that_ended_them():
    t = step_trace()
    idle = dict(tracing.idle_by_span(t, SPANS, tracing.owners(t, SPANS), top=20))
    _, g0, g1 = tracing.busy_and_gaps(t)
    assert sum(idle.values()) == pytest.approx(float((g1 - g0).sum()) / 1e9)
    assert idle == pytest.approx({"encoder": 28e-9, "loss.ssim": 110e-9, "loss": 70e-9, "backward": 83e-9,
                                  "loss.ssim.bwd": 36e-9, "loss.bwd": 90e-9, "encoder.bwd": 85e-9,
                                  "optimizer": 120e-9, "step": 120e-9})
    # the idle list the breakdown already had is left as it was
    assert [k for k, _ in tracing.breakdown(t)["idle_gaps"]][0] == "cudaLaunchKernel"


def test_a_run_without_spans_reads_nothing():
    t = step_trace()
    owner = tracing.owners(t, [])
    assert (owner == -1).all()
    _, total = tracing.device_ns(t, [], owner)
    assert all(tracing.layer_ms_per_step([], total, names) is None for names in tracing.layers().values())
    assert tracing.idle_by_span(t, [], owner)[0][0] == "(no span)"


def test_route_launches_seen_counts_k1_with_its_zero_fill():
    t = summary([(0, 1, "Memset (Device)", 1), (1, 2, "void msaa_bin_kernel(...)", 2),
                 (2, 3, "void msaa_fine_kernel<3>(...)", 3), (3, 4, "void gather_rows_kernel(...)", 4),
                 (4, 5, "Memset (Device)", 5), (5, 6, "void scatter_rows_kernel<4>(...)", 6)], [])
    assert layer_trace.route_launches_seen(t) == {"rasterize_msaa.device_launches": 3, "gather_rows.launches": 1,
                                                  "scatter_rows.launches": 1}


def test_overlapping_ops_count_once_so_the_spans_add_up_to_busy():
    spans = [Span("step", 0, 100, None, 0, MAIN, 0), Span("encoder", 0, 10, 0, 0, MAIN, 0),
             Span("loss", 10, 20, 0, 0, MAIN, 0)]
    # the loss's op starts while the encoder's still runs (a dependent launch
    # may overlap its predecessor's tail), and one inside it adds no time
    t = summary([(30, 50, "a", 1), (45, 60, "b", 2), (52, 55, "c", 3)],
                [(1, 2, "cudaLaunchKernel", 1, MAIN32), (11, 12, "cudaLaunchKernel", 2, MAIN32),
                 (13, 14, "cudaLaunchKernel", 3, MAIN32)])
    assert tracing.busy_ns(t).tolist() == [20, 10, 0]
    own, total = tracing.device_ns(t, spans, tracing.owners(t, spans))
    busy, _, _ = tracing.busy_and_gaps(t)
    assert total[0] == 30 and busy == pytest.approx(30e-9) and own[1] == 20 and own[2] == 10


# each layer metric of BENCHMARK.json and the device ns its spans hold in step_trace
LAYER_NS = {"encoder_device_ms.train": 30 + 80, "hand_device_ms.train": None, "renderer_device_ms.train": None,
            "loss_device_ms.train": 10 + 30 + 10 + 30, "ssim_device_ms.train": 30 + 30,
            "vgg_device_ms.train": None, "optimizer_device_ms.train": 20}


def test_each_layer_metric_reads_its_spans_device_ms():
    names = {m["name"] for m in spec.load_benchmark()["per_layer"] if m["name"].endswith("_device_ms.train")}
    assert names == set(LAYER_NS)
    run = {"trace": step_trace(), "spans": SPANS, "steps": 1}
    for name, ns in LAYER_NS.items():
        got = spec.metric_reader(name)(run)
        assert (got is None) if ns is None else got == pytest.approx(ns / 1e6), name
    # a run without spans, or untraced, reads nothing
    for run in ({"trace": step_trace(), "spans": [], "steps": 1}, {"trace": None, "spans": None, "steps": 1}):
        assert all(spec.metric_reader(name)(run) is None for name in LAYER_NS)


def test_a_port_without_spans_traces_with_none(monkeypatch):
    from hifihr_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    result, summary, spans, counters = tracing.profile_window(lambda: 7)
    assert result == 7 and spans == [] and set(counters) == set(profiling.counters)
    assert "reduce_s" in summary and "cpu_thread" in summary
