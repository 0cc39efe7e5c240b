"""The arithmetic the metric readers share, over one run's record (`run`,
built by run.py): the rate over the whole window, the device's idle
share and operations per step from the trace, MFU, the kernels' roofline
shares and the layers' device time from the spans. Each returns None where
the run has nothing to read."""

from __future__ import annotations

from benchmark import roofline, spec, tracing


def rate(run: dict) -> float:
    """Images finished in the window over the window's seconds."""
    return run["images"] / run["window_s"]


def idle_share(run: dict) -> float | None:
    """100 (1 - device busy / traced window): busy is the union of every
    kernel's, copy's and memset's interval."""
    if run.get("trace") is None or not len(run["trace"]["dev_start"]):
        return None
    busy, _, _ = tracing.busy_and_gaps(run["trace"])
    return 100.0 * (1.0 - busy / run["window_s"])


def ops_per_step(run: dict) -> float | None:
    """Device operations (kernels, copies, memsets) in the trace per step,
    batch or request of the window."""
    if run.get("trace") is None or not run["steps"] or not len(run["trace"]["dev_start"]):
        return None
    return len(run["trace"]["dev_start"]) / run["steps"]


def mfu(run: dict) -> float | None:
    """100 x the least time of a step's matrix products and convolutions at
    the published peaks (bf16 for the encoder where the configuration runs
    it in bf16, fp32 for the rest) over the measured time per step."""
    f = run.get("flops")
    if not f or not run["steps"]:
        return None
    b = run["batch"]
    return 100.0 * roofline.step_bound_s(f["bf16_per_image"] * b, f["fp32_per_image"] * b) / (
        run["window_s"] / run["steps"])


def kernel_roofline(run: dict, kernel: str) -> float | None:
    """100 x one call's least time (from what the call had to do) over its
    device time in the trace; kernels/<kernel>.py says what a call is."""
    if run.get("trace") is None or not run.get("calls"):
        return None
    here = run.get("here", spec.HERE)
    t = tracing.kernel_seconds_per_call(run["trace"], kernel, here)
    b = tracing.kernel_bound_seconds(run["calls"], kernel, here)
    if not t or b is None:
        return None
    return 100.0 * b / t


def span_device_ms(run: dict, names: tuple) -> float | None:
    """Device ms a step of the port's spans named `names` with their
    descendants (a layer: its forward and `.bwd` spans), overlapping
    operations counted once; None where the run recorded none of them."""
    got = tracing.attribution(run)
    if got is None:
        return None
    return tracing.layer_ms_per_step(run["spans"], got[2], names)
