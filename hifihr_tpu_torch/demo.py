"""Single-image inference demo (counterpart of the root demo.py): image ->
mesh OBJ, prediction panel and an 8-view turntable strip.

    python -m hifihr_tpu_torch.demo --image path.jpg [--checkpoint output/run/model]
        [--config_json configs/...json] [--out demo_out] [--device cuda|cpu]

It builds the model (the flagship, ResNet-50 + MANO with the light
estimator, unless `--config_json` names another; seeded random weights),
restores `--checkpoint`'s texturehand_latest.pt through the port's
CheckpointManager, and runs one eval forward (K1 at the config's
subsamples, K2). It writes `hand.obj` (NIMBLE's UV-textured skin where its
textures are a UV map, else the posed MANO mesh with the root restored),
`panel.png` (needs matplotlib, which raises where it is missing, as in the
JAX package) and `turntable.png` (utils/visualize.py::multiview_render: K1
at 2 x 2 subsamples). It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--config_json", default=None)
    parser.add_argument("--out", default="demo_out")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def load_config(config_json: str | None):
    from hifihr_tpu_torch.config import Config

    if config_json:
        return Config.from_json(config_json)
    return Config(pretrain="res50", hand_model="mano", render=True, light_estimation=True)


def load_input(path: str, size: int) -> np.ndarray:
    """The image as (S, S, 3) float32 in [0, 1], resized as the JAX demo
    resizes it (a full-frame crop) when it is not S x S."""
    from hifihr_tpu_torch.data.freihand import _load_image

    img = _load_image(path)
    if img.shape[:2] != (size, size):
        from hifihr_tpu_torch.geometry.crops import resized_crop

        img = resized_crop(img, 0, 0, img.shape[0], img.shape[1], [size, size])
    return np.asarray(img[..., :3], np.float32)


def demo_camera(size: int, device) -> tuple:
    """The demo's intrinsics (f = 1.5 S, centred) and root (0, 0, 0.5)."""
    f = size * 1.5
    K = torch.tensor([[[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]]], dtype=torch.float32, device=device)
    root = torch.tensor([[[0.0, 0.0, 0.5]]], dtype=torch.float32, device=device)
    return K, root


def forward(model, imgs: torch.Tensor, K: torch.Tensor, root: torch.Tensor) -> dict:
    """The eval forward with mode_train=False and the 2D joints attached."""
    from hifihr_tpu_torch.models.hifihr import attach_j2d
    from hifihr_tpu_torch.training.steps import set_fp32_numerics

    set_fp32_numerics()
    model.eval()
    with torch.inference_mode():
        return attach_j2d(model(imgs, K, root, mode_train=False), Ks=K, root_xyz=root)


def write_mesh(out_dir: str, model, out: dict, root: torch.Tensor) -> tuple:
    """hand.obj as the JAX demo writes it; returns (verts, faces) of the
    mesh written."""
    from hifihr_tpu_torch.utils import visualize

    path = os.path.join(out_dir, "hand.obj")
    if model.config.hand_model == "nimble" and out["textures"].ndim == 4:
        # the UV-textured NIMBLE skin (reference save_textured_nimble,
        # visualize_util.py:16,27)
        verts = out["skin_verts"][0].cpu().numpy()
        faces = model.nimble.faces_np
        visualize.save_obj(path, verts, faces, vert_uv=model.nimble.vert_uv_np,
                           texture_image=out["textures"][0].cpu().numpy())
    else:
        verts = (out["mano_verts"][0] + root[0]).cpu().numpy()
        faces = out["mano_faces"].cpu().numpy()
        visualize.save_obj(path, verts, faces)
    return verts, faces


def write_turntable(out_dir: str, verts: np.ndarray, faces: np.ndarray, device) -> np.ndarray:
    """turntable.png: 8 views side by side; returns the (8, S, S, 4) frames."""
    from hifihr_tpu_torch.utils import visualize

    colors = np.full((len(verts), 3), 0.7, np.float32)
    frames = visualize.multiview_render(verts, faces, colors, n_views=8, device=device)
    visualize.write_png(os.path.join(out_dir, "turntable.png"), np.concatenate(list(frames[..., :3]), axis=1))
    return frames


def main(argv=None) -> dict:
    from hifihr_tpu_torch import resolve_device
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.utils import visualize

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config_json)
    model = build_model(cfg, device=device, seed=0)
    if args.checkpoint:
        from hifihr_tpu_torch.training.checkpoint import CheckpointManager
        from hifihr_tpu_torch.training.train_state import create_train_state

        CheckpointManager(args.checkpoint, cfg.save_mode).restore(create_train_state(model, cfg))
    s = cfg.image_size
    imgs = torch.as_tensor(load_input(args.image, s)[None], device=device)
    K, root = demo_camera(s, device)
    out = forward(model, imgs, K, root)

    os.makedirs(args.out, exist_ok=True)
    verts, faces = write_mesh(args.out, model, out, root)
    visualize.save_prediction_grid(os.path.join(args.out, "panel.png"), {"imgs": imgs.cpu().numpy()},
                                   {k: v.cpu().numpy() for k, v in out.items() if torch.is_tensor(v)}, max_rows=1)
    frames = write_turntable(args.out, verts, faces, device)
    print(f"wrote {args.out}/hand.obj, panel.png, turntable.png")
    return {"outputs": out, "verts": verts, "faces": faces, "frames": frames}


if __name__ == "__main__":
    main()
