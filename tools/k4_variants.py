"""Compare versions of K4's CUDA source on identical inputs, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/k4_variants.py NAME=PATH[@OLD@NEW] ...

Each NAME=PATH is a copy of a `raster_face.cu` source (this checkout's
`hifihr_tpu_torch/csrc/raster_face.cu`, or an older commit's unpacked with
`git archive`); `@OLD@NEW` builds it with the text OLD replaced by NEW, which
must occur exactly once. A source exports either the route of three
launches (`hifihr_face_route`, its scratch sized by `hifihr_face_mask_words`)
or the first design's single launch (`hifihr_face_raster`). Every version is
built with the port's nvcc flags into build/k4_variants/ and called as the
port's wrapper calls K4. The inputs, all (B, F, 9) face corners:

  - the eval hand: the first 8 posed meshes of chip_smoke.py's scene,
    projected at K * 3 to 672^2 (chip_smoke.py's phase 8);
  - the NIMBLE-sized torus scenes (chip_smoke.torus_scene, 11,926 faces,
    8 images at 672^2, about 12% and about 60% covered);
  - the train hands: the input of the SSAA train step's K4 route (batch 8),
    captured at step 1 and at step --steps.

For each input and version it prints whether face_id and zbuf equal the
plain version bit for bit, and the time of one call, taken twice in the
order v1 .. vn vn .. v1: `ms` by CUDA events (mean of 50 back-to-back
calls, median of 3 groups, as chip_smoke.time_ms) and `device_ms`, the sum
of the call's launches' device times (torch.profiler). One JSON line per
input; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hifihr_tpu_torch import kernels  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "k4_variants")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(specs: list[str]) -> dict:
    """NAME=PATH[@OLD@NEW] -> {NAME: the loaded library}, one nvcc each, all
    started together."""
    procs = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    for spec in specs:
        name, rest = spec.split("=", 1)
        path, *sub = rest.split("@")
        with open(os.path.join(ROOT, path)) as f:
            src = f.read()
        if sub:
            old, new = sub
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times in {path}")
            src = src.replace(old, new)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT_DIR, f"lib{name}.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        if hasattr(lib, "hifihr_face_route"):
            for fn, (argtypes, restype) in kernels.SIGNATURES["raster_face"].items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        else:
            lib.hifihr_face_raster.argtypes, lib.hifihr_face_raster.restype = [_P, _I, _I, _I, _P, _P, _P], _I
        libs[name] = lib
    return libs


def run(lib, tri: torch.Tensor, size: int) -> tuple:
    """One K4 call through `lib`, as hifihr_tpu_torch.render.raster's
    select_face_id_cuda makes it: (face_id, zbuf)."""
    B, F, _ = tri.shape
    fid = torch.empty((B, size, size), dtype=torch.int32, device=tri.device)
    zbuf = torch.empty((B, size, size), dtype=torch.float32, device=tri.device)
    stream = kernels.stream_ptr(tri.device)
    if hasattr(lib, "hifihr_face_route"):
        mask = torch.empty(lib.hifihr_face_mask_words(B, F, size), dtype=torch.int32, device=tri.device)
        err = lib.hifihr_face_route(tri.data_ptr(), B, F, size, mask.data_ptr(), fid.data_ptr(),
                                    zbuf.data_ptr(), stream, ctypes.byref(ctypes.c_int(0)))
    else:
        err = lib.hifihr_face_raster(tri.data_ptr(), B, F, size, fid.data_ptr(), zbuf.data_ptr(), stream)
    kernels.check(err, "raster_face")
    return fid, zbuf


def call_device_ms(fn) -> float:
    """The summed device time of one call's launches; a profile that saw no
    launch is taken again."""
    for _ in range(3):
        ms = sum(t for t, _ in cs.device_ms(fn).values())
        if ms > 0:
            return ms
    raise RuntimeError("k4_variants: the profiler saw no launch in three profiles")


def compare(libs: dict, tri: torch.Tensor, size: int, what: str) -> None:
    from hifihr_tpu_torch.render.raster import select_face_id_plain

    fid_p, zb_p = select_face_id_plain(tri, size)
    res = {}
    for name, lib in libs.items():
        fid, zb = run(lib, tri, size)
        res[name] = {"bit_equal": torch.equal(fid, fid_p) and torch.equal(zb, zb_p), "ms": [], "device_ms": []}
    for name in list(libs) + list(reversed(libs)):
        fn = lambda: run(libs[name], tri, size)  # noqa: E731
        res[name]["ms"].append(cs.time_ms(fn, reps=50))
        res[name]["device_ms"].append(call_device_ms(fn))
    boxes = cs.face_boxes(tri)
    pairs = cs.box_pairs(boxes, size)
    bound_ms, bound_by = cs.bound(tri.numel() * 4 + 2 * fid_p.numel() * 4, pairs * cs.K4_OPS_PER_PAIR)
    print(json.dumps({"input": what, "shape": list(tri.shape), "image_size": size,
                      "covered": (fid_p >= 0).float().mean().item(), "box_pairs": pairs,
                      "bound_ms": bound_ms, "bound_by": bound_by, "versions": res}), flush=True)


def scenes(libs: dict) -> None:
    from hifihr_tpu_torch.render import raster
    from hifihr_tpu_torch.render.renderer import _scale_intrinsics

    batch = cs.flagship_batch("cuda")
    verts, _, faces, _ = cs.posed_meshes(batch)
    n, size = cs.SSAA_B, cs.S * cs.AA
    vs = raster.project_to_screen(verts[:n], _scale_intrinsics(batch["Ks"][:n], float(cs.AA)))
    compare(libs, raster.face_triangles(vs, faces), size, "the eval hand")
    for i, (share, radius) in enumerate(cs.TORUS_RADII.items()):
        tv, tf = cs.torus_scene(size, radius, seed=10 + i)
        tri = raster.face_triangles(torch.tensor(tv, device="cuda"), torch.tensor(tf, device="cuda").long())
        compare(libs, tri, size, f"the NIMBLE-sized torus, {share} covered")


def train_hands(libs: dict, steps: int) -> None:
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    batch = {k: v[:cs.SSAA_B] for k, v in cs.flagship_batch("cuda").items()}
    cfg = cs.train_config("ssaa")
    model = build_model(cfg, device="cuda", seed=0)
    state = create_train_state(model, cfg, batch)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    sched = make_sched(cfg, 0)
    for k in range(1, steps + 1):
        if k in (1, steps):
            with cs.captured_kernel_inputs() as got:
                state, _ = step(state, batch, sched)
            for tri, size in got["K4"]:
                compare(libs, tri, size, f"the ssaa train step's hand at step {k}")
            del got
        else:
            state, _ = step(state, batch, sched)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("versions", nargs="+", help="NAME=PATH[@OLD@NEW]")
    ap.add_argument("--steps", type=int, default=41, help="the later train step whose inputs are captured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(args.versions)
    kernels.build_all()
    from hifihr_tpu_torch.training.steps import set_fp32_numerics

    set_fp32_numerics()
    scenes(libs)
    train_hands(libs, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
