"""K5, SSIM (hifihr_tpu_torch/losses/ssim.py `_SSIMKernel`, csrc/ssim.cu): a
call is one SSIM term. Its forward is `ssim_forward_kernel` (the separable
moments, the value's block sums and, where a gradient is wanted, the
partial maps) and `ssim_sum_kernel` (the mean); its backward is
`ssim_backward_kernel` (dx, and dy where it is wanted). Nothing is filled
before them. A call's time is the three kernels' mean times a launch
summed: in a train step every SSIM term has its backward.

A call keeps its images' shape and which gradients it wants. Its least time
is the larger of what the function must move and what it must compute,
over N = B H W C floats (SAME padding: one value of the map a float):
- bytes: both images read once (2 N) and each gradient wanted written once
  (N each). The partial maps that K5 writes in forward and reads back in
  backward are its own choice, not the function's, and are not counted;
  nor are the block sums and the mean (a few kB);
- operations: the forward's x², y² and xy (3 an element) and the five
  moments' two 11-tap passes (5 x 2 x 11 fused multiply-adds, 220 flops);
  the backward's filtering of the partial maps it needs, the same two
  passes each (44 flops a map): a, b and c for dx, a', b and c for dy,
  four for both.
  The map's own arithmetic (some 25 operations and a division an element)
  and the backward's combination are left out, so the count is a floor.
At (64, 224, 224, 3) with dx alone that is 3 N floats, 0.0345 ms at
3.35 TB/s, and 355 flops an element, 3.42 GFLOP, 0.0510 ms at 67 TFLOP/s
of fp32: the operations bound it."""

import math

from benchmark import roofline

WRAPS = ("hifihr_tpu_torch.losses.ssim", "_SSIMKernel.apply")
TRACE = (("ssim_forward_kernel", ()), ("ssim_sum_kernel", ()), ("ssim_backward_kernel", ()))

TAPS = 11
FORWARD_OPS = 3 + 5 * 2 * TAPS * 2  # products, then five moments' two passes of fused multiply-adds
MAP_OPS = 2 * TAPS * 2  # one partial map's two passes in backward


def record(img1, img2, with_dx, with_dy):
    return tuple(img1.shape), bool(with_dx), bool(with_dy)


def bound_s(call) -> float:
    shape, with_dx, with_dy = call
    n = math.prod(shape)
    maps = (3 if with_dx or with_dy else 0) + (with_dx and with_dy)
    nbytes = (2 + with_dx + with_dy) * n * 4
    return roofline.bound_s(nbytes, (FORWARD_OPS + maps * MAP_OPS) * n)
