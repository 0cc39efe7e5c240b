"""Compare versions of K3's CUDA source on identical inputs, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/k3_variants.py NAME=PATH[@OLD@NEW] ...

Each NAME=PATH is a copy of a `scatter_rows.cu` source (this checkout's
`hifihr_tpu_torch/csrc/scatter_rows.cu`, or an older commit's unpacked with
`git archive`); `@OLD@NEW` builds it with the text OLD replaced by NEW, which
must occur exactly once. Every version is built with the port's nvcc flags
into build/k3_variants/ and called as the port's wrapper calls K3 (a zeroed
output, then one launch). The inputs:

  - the eval hand: the (64, 50176, 27) gradient that an L1 loss on the
    shaded MSAA render of chip_smoke.py's posed scene sends to K2's output,
    and the SSAA corner fetch's seeded (8, 451584, 9) and (8, 451584, 27)
    cotangents at 672^2 (chip_smoke.py's phase 8);
  - the train hands: the input of every K3 launch of the flagship MSAA
    train step (batch 64) and SSAA train step (batch 8), captured at step 1
    and at step --steps.

For each input and version it prints whether the result lies within the
atomics bound of the plain version (with and without the n 2^-126 subnormal
term, see chip_smoke.k3_launch), whether a sum of ones equals every face's
row count exactly, and the time of one call (CUDA events, mean of 50 calls,
median of 3 groups), taken twice in the order v1 .. vn vn .. v1. One JSON
line per input; the card's name and power limit first.
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

OUT_DIR = os.path.join(ROOT, "build", "k3_variants")


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
        argtypes, restype = kernels.SIGNATURES["scatter_rows"]["hifihr_scatter_rows"]
        lib.hifihr_scatter_rows.argtypes, lib.hifihr_scatter_rows.restype = argtypes, restype
        libs[name] = lib
    return libs


def run(lib, values: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """One K3 call through `lib`, as hifihr_tpu_torch.render.gather._scatter
    makes it."""
    B, P, D = values.shape
    out = torch.zeros((B, n_rows, D), dtype=torch.float32, device=values.device)
    kernels.check(lib.hifihr_scatter_rows(values.data_ptr(), idx.data_ptr(), B, n_rows, D, P,
                                          out.data_ptr(), kernels.stream_ptr(values.device)), "scatter_rows")
    return out


def compare(libs: dict, g: torch.Tensor, idx: torch.Tensor, n_rows: int, what: str) -> None:
    from hifihr_tpu_torch.render.gather import scatter_rows_plain

    ref = scatter_rows_plain(g, idx, n_rows)
    rows = scatter_rows_plain(torch.ones_like(g[..., :1]), idx, n_rows)
    abs_sum = scatter_rows_plain(g.abs(), idx, n_rows)
    rounding = 2.0 * (rows - 1).clamp(min=0) * 2.0**-24 * abs_sum
    tol = rounding + 2.0 * rows * 2.0**-126
    ones = torch.ones_like(g)
    covered = int(((idx >= 0) & (idx < n_rows)).sum().item())
    bound_ms, _ = cs.bound(idx.numel() * 4 + covered * g.shape[2] * 4 + ref.numel() * 4, covered * g.shape[2])
    res = {}
    for name, lib in libs.items():
        diff = (run(lib, g, idx, n_rows) - ref).abs()
        res[name] = {"ok": bool((diff <= tol).all()), "ok_without_subnormal_term": bool((diff <= rounding).all()),
                     "counts_exact": torch.equal(run(lib, ones, idx, n_rows), rows.expand(ref.shape)),
                     "max_abs_err": diff.max().item(), "ms": []}
    order = list(libs) + list(reversed(libs))
    for name in order:
        res[name]["ms"].append(cs.time_ms(lambda: run(libs[name], g, idx, n_rows), reps=50))
    print(json.dumps({"input": what, "shape": list(g.shape), "covered_share": covered / idx.numel(),
                      "largest_face_rows": int(rows.max().item()), "bound_ms": bound_ms, "versions": res}),
          flush=True)


def eval_hand(libs: dict) -> None:
    from hifihr_tpu_torch.render import gather, raster, raster_msaa
    from hifihr_tpu_torch.render.interpolate import pack_face_table
    from hifihr_tpu_torch.render.renderer import _scale_intrinsics

    batch = cs.flagship_batch("cuda")
    verts, vs, faces, attrs = cs.posed_meshes(batch)
    fid, cov, _ = raster_msaa.rasterize_msaa(vs, faces, cs.S)
    table = pack_face_table(vs, faces, attrs)
    idx = fid.reshape(cs.B, -1).contiguous()
    g = cs.l1_render_grad(batch, fid, cov, gather.gather_rows(table, idx))
    compare(libs, g, idx, table.shape[1], "eval hand, the MSAA render's backward input")
    del g

    n = cs.SSAA_B
    vs3 = raster.project_to_screen(verts[:n], _scale_intrinsics(batch["Ks"][:n], float(cs.AA)))
    fid3, _ = raster.rasterize_face_id(vs3, faces, cs.S * cs.AA)
    idx3 = fid3.reshape(n, -1).contiguous()
    g_tri, g_att = cs.ssaa_fetch_grads(idx3, 3 * (attrs.shape[-1] + 3))
    compare(libs, g_tri, idx3, faces.shape[0], "eval hand, the SSAA corner fetch's triangle cotangent")
    compare(libs, g_att, idx3, faces.shape[0], "eval hand, the SSAA corner fetch's attribute cotangent")


def train_hands(libs: dict, steps: int) -> None:
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    full = cs.flagship_batch("cuda")
    for aa_mode, n in (("msaa", cs.B), ("ssaa", cs.SSAA_B)):
        batch = {k: v[:n] for k, v in full.items()}
        cfg = cs.train_config(aa_mode)
        model = build_model(cfg, device="cuda", seed=0)
        state = create_train_state(model, cfg, batch)
        step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
        sched = make_sched(cfg, 0)
        for k in range(1, steps + 1):
            if k in (1, steps):
                with cs.captured_kernel_inputs() as got:
                    state, _ = step(state, batch, sched)
                for i, (g, idx, n_rows) in enumerate(got["K3"]):
                    compare(libs, g, idx, n_rows, f"launch {i} of the {aa_mode} train step at step {k}")
                del got
            else:
                state, _ = step(state, batch, sched)
        del model, state, step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("versions", nargs="+", help="NAME=PATH[@OLD@NEW]")
    ap.add_argument("--steps", type=int, default=41, help="the later train step whose inputs are captured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(args.versions)
    kernels.build_all()
    from hifihr_tpu_torch.training.steps import set_fp32_numerics

    set_fp32_numerics()
    eval_hand(libs)
    train_hands(libs, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
