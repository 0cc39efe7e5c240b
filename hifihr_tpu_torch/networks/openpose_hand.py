"""CPM hand keypoint detector, openpose-style (counterpart of
hifihr_tpu/networks/openpose_hand.py), the generator of the `open_2dj` /
`open_2dj_con` pseudo-labels the training consumes.

The reference's offline 2D keypoint labeller (utils/openpose_detector/src/
model.py handpose_model:143-220, src/hand.py): a VGG-style stem to 128
channels at stride 8, a 22-channel stage-1 head, then 5 refinement stages
over concat(heatmaps, features) with 7x7 convs. `HandDetector` averages the
heatmaps of 4 scales, each image resized by `jax.image.resize`'s "cubic"
(Keys' cubic at a = -0.5, half-pixel centres, the kernel widened when
downscaling, weights renormalised at the borders), which
`F.interpolate(mode="bicubic", antialias=True, align_corners=False)`
computes; a 5 x 5 box blur, then each keypoint's peak is the first argmax of
the blurred map and its confidence the unblurred heatmap there.

Weights: `assets/openpose_hand.npz` with keys `<layer>_<kind>` (kernel
HWIO, bias), as tools/convert_openpose.py writes them for the JAX package;
without it the detector runs on a seeded init with flax's initialisers
(lecun_normal kernels, zero biases). Runs on the card unless `device` is
'cpu'. Module names follow the flax layer names.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch import variance_scaling_
from hifihr_tpu_torch.utils.weights import asset_path

OPENPOSE_NPZ = asset_path("openpose_hand.npz")

_STEM = [
    ("conv1_1", 64), ("conv1_2", 64), ("pool", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3_CPM", 128),
]


class HandposeCPM(nn.Module):
    """(B, 3, H, W) NCHW in [-0.5, 0.5] -> (B, 22, H/8, W/8) heatmaps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, ch in _STEM:
            if name != "pool":
                self.add_module(name, nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.conv6_1_CPM = nn.Conv2d(128, 512, 1)
        self.conv6_2_CPM = nn.Conv2d(512, 22, 1)
        for stage in range(2, 7):
            cin = 22 + 128
            for i in range(1, 6):
                self.add_module(f"Mconv{i}_stage{stage}", nn.Conv2d(cin, 128, 7, padding=3))
                cin = 128
            self.add_module(f"Mconv6_stage{stage}", nn.Conv2d(128, 128, 1))
            self.add_module(f"Mconv7_stage{stage}", nn.Conv2d(128, 22, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, _ in _STEM:
            x = Fn.max_pool2d(x, 2) if name == "pool" else Fn.relu(getattr(self, name)(x))
        feat = x
        h = self.conv6_2_CPM(Fn.relu(self.conv6_1_CPM(feat)))
        for stage in range(2, 7):
            y = torch.cat([h, feat], dim=1)
            for i in range(1, 6):
                y = Fn.relu(getattr(self, f"Mconv{i}_stage{stage}")(y))
            y = Fn.relu(getattr(self, f"Mconv6_stage{stage}")(y))
            h = getattr(self, f"Mconv7_stage{stage}")(y)
        return h


def cubic_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), jax.image.resize's "cubic"."""
    return Fn.interpolate(x, size=(size, size), mode="bicubic", antialias=True, align_corners=False)


def state_dict_from_npz(npz_path: str) -> dict:
    """`<layer>_<kind>` arrays (flax layout) -> the CPM's state dict."""
    from hifihr_tpu_torch.convert import state_dict_from_flax

    params: dict = {}
    with np.load(npz_path) as z:
        for key in z.files:
            layer, kind = key.rsplit("_", 1)
            params.setdefault(layer, {})[kind] = z[key]
    return state_dict_from_flax({"params": params})


class HandDetector:
    """Multi-scale heatmap inference and peak extraction -> (peaks,
    confidence)."""

    def __init__(self, image_size: int = 368, scales=(0.5, 1.0, 1.5, 2.0), device=None, seed: int = 0,
                 npz_path: str | None = OPENPOSE_NPZ):
        from hifihr_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.image_size = image_size
        self.scales = tuple(scales)
        self.model = HandposeCPM()
        self.pretrained = bool(npz_path) and os.path.exists(npz_path)
        if self.pretrained:
            self.model.load_state_dict(state_dict_from_npz(npz_path), strict=True)
        else:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for m in self.model.modules():
                    if isinstance(m, nn.Conv2d):
                        variance_scaling_(m.weight, 1.0, m.weight[0].numel(), gen)
                        m.bias.zero_()
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def infer(self, images: torch.Tensor) -> tuple:
        """(B, S, S, 3) float in [0, 1] on the detector's device -> (peaks
        (B, 21, 2) float32 x, y in pixels, conf (B, 21))."""
        from hifihr_tpu_torch.training.steps import set_fp32_numerics

        set_fp32_numerics()  # fp32 convs, as the JAX package computes them on the CPU
        b, s = images.shape[0], images.shape[1]
        x = images.permute(0, 3, 1, 2)
        acc = torch.zeros(b, 22, s, s, device=images.device)
        for scale in self.scales:
            size = int(round(s * scale / 8)) * 8
            hm = self.model(cubic_resize(x, size) - 0.5)
            acc = acc + cubic_resize(hm, s) / len(self.scales)
        hm21 = acc[:, :21]
        # a 5 x 5 average blur ("SAME") before the peak, standing in for
        # the reference's gaussian_filter
        box = torch.full((21, 1, 5, 5), 1.0 / 25.0, device=images.device)
        blurred = Fn.conv2d(hm21, box, padding=2, groups=21)
        idx = blurred.reshape(b, 21, s * s).argmax(-1)  # the first maximum
        conf = hm21.reshape(b, 21, s * s).gather(-1, idx[..., None])[..., 0]
        peaks = torch.stack([idx % s, idx // s], dim=-1).float()
        return peaks, conf

    def __call__(self, images: np.ndarray) -> tuple:
        """(B, S, S, 3) float [0, 1] -> (peaks (B, 21, 2), conf (B, 21, 1))
        numpy."""
        peaks, conf = self.infer(torch.as_tensor(np.asarray(images, np.float32), device=self.device))
        return peaks.cpu().numpy(), conf.cpu().numpy()[..., None]


def detect_directory(image_dir: str, out_json: str, batch: int = 16, device=None, detector=None) -> str:
    """Walk a dataset's image directory and write detect.json
    [[coords, conf], ...] (the format the FreiHAND and HO-3D loaders read,
    data/dataset.py:1430, 1960), images in name order."""
    from hifihr_tpu_torch.data.freihand import _load_image

    det = detector or HandDetector(device=device)
    if not det.pretrained:
        print("WARNING: assets/openpose_hand.npz absent; using random features")
    names = sorted(f for f in os.listdir(image_dir) if f.endswith((".jpg", ".png")))
    results = []
    for i in range(0, len(names), batch):
        imgs = np.stack([_load_image(os.path.join(image_dir, n)) for n in names[i:i + batch]])
        peaks, conf = det(imgs)
        for p, c in zip(peaks, conf):
            results.append([p.tolist(), c.tolist()])
    with open(out_json, "w") as f:
        json.dump(results, f)
    return out_json
