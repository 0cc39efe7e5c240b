"""The metric arithmetic on made-up records and traces, and the kernels'
work counts at a small size."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import measures, roofline, tracing


def trace(dev: list, cpu: list = ()) -> dict:
    """A summary of (start_ns, end_ns, name) device and host events."""
    dev, cpu = sorted(dev), sorted(cpu)
    return {"dev_start": np.array([d[0] for d in dev], np.int64), "dev_end": np.array([d[1] for d in dev], np.int64),
            "dev_name": [d[2] for d in dev], "cpu_start": np.array([c[0] for c in cpu], np.int64),
            "cpu_end": np.array([c[1] for c in cpu], np.int64), "cpu_name": [c[2] for c in cpu]}


def test_rate_is_every_image_over_the_whole_window():
    assert measures.rate({"images": 480, "window_s": 2.0}) == 240.0


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    # [0, 10] and [5, 15] overlap into [0, 15]; [20, 30]; [30, 31] touches it
    t = trace([(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (30, 31, "d")])
    busy, g0, g1 = tracing.busy_and_gaps(t)
    assert busy == pytest.approx(26e-9)
    assert g0.tolist() == [15] and g1.tolist() == [20]
    run = {"trace": t, "window_s": 52e-9, "steps": 2}
    assert measures.idle_share(run) == pytest.approx(50.0)
    assert measures.ops_per_step(run) == 2.0


def test_a_trace_without_device_work_reads_nothing():
    run = {"trace": trace([]), "window_s": 1.0, "steps": 3}
    assert measures.idle_share(run) is None and measures.ops_per_step(run) is None


def test_breakdown_names_ops_and_what_the_host_did_in_each_gap():
    t = trace([(0, 10, "k1"), (20, 30, "k2"), (40, 45, "k1")],
              [(0, 12, "aten::conv"), (12, 19, "cudaStreamSynchronize"), (31, 39, "python loop")])
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["k1", 15e-9] and b["device_ops"][1] == ["k2", 10e-9]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {"cudaStreamSynchronize": 10e-9, "python loop": 10e-9}


def test_kernel_time_takes_the_route_and_its_fills():
    t = trace([(0, 2, "Memset (Device)"), (2, 7, "void msaa_bin_kernel(float4 const*)"),
               (7, 17, "void msaa_fine_kernel<3>(float const*)"),
               (20, 23, "void vectorized_elementwise_kernel<FillFunctor>"),
               (23, 30, "void scatter_rows_kernel<4>(float const*)"),
               (31, 35, "void gather_rows_kernel(float const*)")])
    assert tracing.kernel_seconds_per_call(t, "K1") == pytest.approx(17e-9)
    assert tracing.kernel_seconds_per_call(t, "K3") == pytest.approx(10e-9)
    assert tracing.kernel_seconds_per_call(t, "K2") == pytest.approx(4e-9)
    assert tracing.kernel_seconds_per_call(trace([(0, 1, "other")]), "K1") is None


def test_box_pairs_counts_the_pixels_each_box_touches():
    inf = float("inf")
    bbox = torch.tensor([[[0.5, 2.5, 0.5, 0.7], [3.2, 3.3, 3.9, 5.1], [inf, -inf, inf, -inf], [-9, -8, 0, 1]]])
    # 3 x 1, 1 x 2 (rows 3..4 of a 5-px image, clamped), none, off screen
    assert roofline.box_pairs(bbox, 5) == 3 + 2


def test_k2_and_k3_count_each_byte_once():
    idx = torch.tensor([[0, 0, 2, -1], [1, 1, 1, 1]], dtype=torch.int32)
    # distinct rows (0, 2) and (1): 3 rows of 5 floats, idx, the output
    assert roofline.k2_bound_s((2, 3, 5), idx) == pytest.approx((3 * 5 + 8 + 8 * 5) * 4 / roofline.HBM_BYTES_PER_S)
    # 7 covered pixels of 5 floats, idx, the (2, 3, 5) output written
    nbytes = 8 * 4 + 7 * 5 * 4 + 2 * 3 * 5 * 4
    assert roofline.k3_bound_s((2, 4, 5), idx, 3) == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)


def test_k1_bound_is_the_larger_of_bytes_and_operations():
    bbox = torch.tensor([[[0.0, 99.0, 0.0, 99.0]]])  # one face over a 100^2 image
    ops = 100 * 100 * roofline.k1_ops_per_pair(3)
    nbytes = (15 + 4) * 4 + 3 * 100 * 100 * 4
    assert roofline.k1_bound_s(bbox, 100, 3) == pytest.approx(
        max(nbytes / roofline.HBM_BYTES_PER_S, ops / roofline.FP32_OPS_PER_S))


def test_mfu_and_roofline_read_nothing_without_their_source():
    assert measures.mfu({"steps": 3, "batch": 2}) is None
    assert measures.kernel_roofline({"trace": None}, "K1") is None


def test_mfu_is_the_step_bound_over_the_time_per_step():
    run = {"flops": {"bf16_per_image": 989e9, "fp32_per_image": 67e9}, "batch": 2, "window_s": 4.0, "steps": 100}
    assert measures.mfu(run) == pytest.approx(100.0 * (2e-3 + 2e-3) / 0.04)


def test_k5_takes_its_three_kernels():
    t = trace([(0, 4, "void ssim_forward_kernel<3>(float const*)"), (4, 5, "ssim_sum_kernel(double const*)"),
               (10, 13, "void ssim_backward_kernel<false>(float const*)"),
               (20, 26, "void ssim_forward_kernel<3>(float const*)"), (26, 27, "ssim_sum_kernel(double const*)"),
               (30, 35, "void ssim_backward_kernel<false>(float const*)")])
    assert tracing.kernel_seconds_per_call(t, "K5") == pytest.approx((5 + 1 + 4) * 1e-9)
    assert tracing.kernel_seconds_per_call(t, "K1") is None


def test_k5_bound_is_the_larger_of_its_bytes_and_operations():
    """One SSIM term moves its images read once and each wanted gradient
    written once (K5's partial maps are its own, not counted), and computes
    the moments' separable passes and the backward's passes over the maps
    it needs; the larger time of the two bounds it."""
    k5 = tracing.kernel_file("K5")
    n = 64 * 224 * 224 * 3
    # dx alone: 3 N floats, 0.0345 ms; 223 + 3 x 44 = 355 flops an element, 0.0510 ms: the operations
    assert k5.FORWARD_OPS == 223 and k5.MAP_OPS == 44
    assert k5.bound_s(((64, 224, 224, 3), True, False)) == pytest.approx(355 * n / roofline.FP32_OPS_PER_S)
    assert k5.bound_s(((64, 224, 224, 3), True, False)) == pytest.approx(0.0510e-3, rel=2e-3)
    assert 3 * n * 4 / roofline.HBM_BYTES_PER_S == pytest.approx(0.0345e-3, rel=2e-3)
    # dx and dy: 4 maps; dy alone: 3 (a', b, c); no gradient: the forward alone
    assert k5.bound_s(((2, 5, 7, 3), True, True)) == pytest.approx((223 + 4 * 44) * 210 / roofline.FP32_OPS_PER_S)
    assert k5.bound_s(((2, 5, 7, 3), False, True)) == pytest.approx(355 * 210 / roofline.FP32_OPS_PER_S)
    assert k5.bound_s(((2, 5, 7, 3), False, False)) == pytest.approx(223 * 210 / roofline.FP32_OPS_PER_S)
    # the bytes bound where operations are few: roofline.bound_s takes the larger
    assert roofline.bound_s(4 * 210 * 4, 0) == pytest.approx(4 * 210 * 4 / roofline.HBM_BYTES_PER_S)
    calls = {"K5": [((64, 224, 224, 3), True, False), ((2, 5, 7, 3), True, True)]}
    assert tracing.kernel_bound_seconds(calls, "K5") == pytest.approx(
        (k5.bound_s(calls["K5"][0]) + k5.bound_s(calls["K5"][1])) / 2)


def test_k1_to_k3_files_read_what_the_fixed_readers_did():
    """On one recorded tiny run (the flagship's first train steps on the
    CPU), the kernel files' wrappers and bounds give each call's least time
    as K1-K3's fixed readers gave it, and the port's functions are
    themselves again after the block."""
    from bench_tiny import tiny_cell
    from benchmark import calibrate
    from benchmark.reference.render.raster import project_to_screen
    from benchmark.reference.render.raster_msaa import msaa_prep
    from hifihr_tpu_torch.losses import ssim
    from hifihr_tpu_torch.render import gather, renderer

    before = (renderer.PhongRenderer.select_faces, gather._gather, gather._scatter)
    cell = tiny_cell("flagship_mano_res50.train_b64")
    with tracing.kernel_calls(tracing.roofline_kernels(cell.per_layer)) as calls:
        calibrate.program_first_steps(cell, 2**31 + 31, "cpu")
    assert (renderer.PhongRenderer.select_faces, gather._gather, gather._scatter) == before
    assert "apply" not in vars(ssim._SSIMKernel)
    assert sorted(calls) == ["K1", "K2", "K3", "K5"] and not calls["K5"]  # SSIM's kernel runs on the card alone
    fixed = {
        "K1": [roofline.k1_bound_s(msaa_prep(project_to_screen(v, K), faces)[1], size, samples)
               for v, K, faces, size, samples in calls["K1"]],
        "K2": [roofline.k2_bound_s(shape, idx) for shape, idx in calls["K2"]],
        "K3": [roofline.k3_bound_s(shape, idx, n) for shape, idx, n in calls["K3"]],
    }
    for k, bounds in fixed.items():
        assert len(bounds) >= 4, k  # a call each train step at least
        assert tracing.kernel_bound_seconds(calls, k) == float(np.mean(bounds)), k


def test_only_the_kernels_a_cell_reports_are_wrapped():
    """A kernel file whose roofline the cell does not report wraps nothing in
    its traced window: K2 alone is wrapped for a k2_roofline metric."""
    from hifihr_tpu_torch.losses import ssim
    from hifihr_tpu_torch.render import gather, renderer

    per_layer = [{"name": "k2_roofline.train"}, {"name": "mfu.train"}, {"name": "device_idle_share.train"}]
    assert tracing.roofline_kernels(per_layer) == ["K2"]
    assert tracing.roofline_kernels([{"name": "mfu.train"}]) == []
    select, gather_fn, scatter = renderer.PhongRenderer.select_faces, gather._gather, gather._scatter
    with tracing.kernel_calls(tracing.roofline_kernels(per_layer)) as calls:
        assert gather._gather is not gather_fn
        assert (renderer.PhongRenderer.select_faces, gather._scatter) == (select, scatter)
        assert "apply" not in vars(ssim._SSIMKernel)
    assert sorted(calls) == ["K2"] and gather._gather is gather_fn
