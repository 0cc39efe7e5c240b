"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exports a plain C function and compiles on its own into
`build/hifihr_tpu_torch/lib<name>.so` (next to the package, in the checkout),
with `nvcc -gencode arch=compute_90a,code=sm_90a`. The library is loaded with
ctypes. A build happens at first use, or for all kernels at once (one nvcc
process per source, started together) through `build_all`; a library whose
source hash matches is reused. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hifihr_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # the rasteriser's edge tests must round every product and sum on its
    # own, as the plain PyTorch version does (no contracted multiply-add)
    "-fmad=false",
)

# C signatures: name -> (argtypes, restype). Pointers and the stream are
# c_void_p, so ctypes does not cut them to 32 bits.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "raster_msaa": {"hifihr_msaa_raster": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
                    "hifihr_msaa_mask_words": ([_I, _I, _I], ctypes.c_longlong)},
    "gather_rows": {"hifihr_gather_rows": ([_P, _P, _I, _I, _I, _I, _P, _P], _I)},
    "scatter_rows": {"hifihr_scatter_rows": ([_P, _P, _I, _I, _I, _I, _P, _P], _I)},
    "raster_face": {"hifihr_face_route": ([_P, _I, _I, _I, _P, _P, _P, _P, _P], _I),
                    "hifihr_face_mask_words": ([_I, _I, _I], ctypes.c_longlong)},
    "ssim": {"hifihr_ssim_blocks": ([_I, _I, _I, _I], _I),
             "hifihr_ssim_forward": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I),
             "hifihr_ssim_sum": ([_P, _I, ctypes.c_longlong, _P, _P], _I),
             "hifihr_ssim_backward": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I)},
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str, verbose: bool):
    src, out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"  # processes building at once never share a file
    cmd = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_build(name: str, started, verbose: bool) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={proc.returncode}):\n{log}")
    if verbose and log.strip():
        print(f"[nvcc {name}]\n{log.rstrip()}")
    os.replace(tmp, out)


def build_all(verbose: bool = False) -> None:
    """Compile every kernel source in parallel (one nvcc process each)."""
    started = {name: _start_build(name, verbose) for name in SIGNATURES}
    errors = []
    for name, s in started.items():
        try:
            _finish_build(name, s, verbose)
        except RuntimeError as e:  # finish every build before reporting
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish_build(name, _start_build(name, verbose=False), verbose=False)
        lib = ctypes.CDLL(_lib_path(name)[1])
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as the launch argument."""
    return torch.cuda.current_stream(device).cuda_stream
