"""ctypes bindings for the loaders' native image work (counterpart of
hifihr_tpu/data/native.py): JPEG decode and the uint8 affine warps.

Two libraries, each built at first use from the port's own sources into
build/hifihr_tpu_torch/ (the source, flags and host CPU's flags hashed into
the file name, as kernels.py does for the CUDA kernels), and never from or
into native/, both with native/build.sh's flags (`-O3 -march=native
-shared -fPIC`):

- `csrc/imgwarp.cpp`, the warps: g++ only, on every host;
- `csrc/jpeg_libjpeg.cpp`, the decode through libjpeg (`-ljpeg` besides),
  where jpeglib.h and libjpeg are installed; bit-equal to the JAX package's
  native decode on the same host.

The JPEG decoder is picked once per process (`decoder()`) and logged:
libjpeg where it builds, else Pillow, as the JAX package's `_load_image`
falls back to it (hifihr_tpu/data/freihand.py:41-52). A failed build of the
warp library raises, as does a failed decode, and so does a host with
neither decoder. The ctypes calls release the GIL, so the loader's threads
decode and warp in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hifihr_tpu_torch")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")  # native/build.sh's

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_IP = ctypes.POINTER(ctypes.c_int)
_WARP_ARGS = [_P, _I, _I, _I, _I, _P, _P, _I, _I, _I]
# name -> (source, linker flags, {function: (argtypes, restype)})
LIBRARIES = {
    "imgwarp": ("imgwarp.cpp", (), {"warp_affine_batch": (_WARP_ARGS, None),
                                     "warp_affine_batch_u8": (_WARP_ARGS, None)}),
    "jpeg_libjpeg": ("jpeg_libjpeg.cpp", ("-ljpeg",),
                     {"decode_jpeg": ([ctypes.c_char_p, _L, _P, _I, _I, _IP, _IP], _I)}),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_decoder: str | None = None  # picked once per process


def _cpu_flags() -> str:
    """The host CPU's feature flags: -march=native compiles for them, so a
    library built on another CPU is never picked up (it could die of an
    illegal instruction here)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def library_path(name: str) -> str:
    """Where LIBRARIES[name] is built: its source, flags, link flags and the
    host CPU's flags hashed into the name."""
    source, link, _ = LIBRARIES[name]
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS + (_cpu_flags(),) + link).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def load(name: str) -> ctypes.CDLL:
    """The built library LIBRARIES[name], building it first if needed; a
    failed build raises RuntimeError with the compiler's output."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        source, link, signatures = LIBRARIES[name]
        out = library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"  # processes building at once never share a file
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the port's image library builds with g++")
            cmd = [gxx, *GXX_FLAGS, os.path.join(CSRC_DIR, source), *link, "-o", tmp]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {source} failed (rc={r.returncode}):\n"
                                   f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(out)
        except OSError as exc:  # e.g. a library it links against is missing at run time
            raise RuntimeError(f"loading {out} failed: {exc}") from exc
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
        return lib


def decoder() -> str:
    """The JPEG decoder of this process: "libjpeg" where the port's libjpeg
    build compiles and links, else "pil" (Pillow; without it this raises).
    Picked once, and logged."""
    global _decoder
    if _decoder is None:
        try:
            load("jpeg_libjpeg")
            picked = "libjpeg"
        except RuntimeError as exc:
            lines = str(exc).splitlines()
            first = next((ln for ln in lines if "error" in ln), lines[0])
            try:
                import PIL  # noqa: F401 - the fallback, as in the JAX package
            except ImportError:
                raise RuntimeError(f"no JPEG decoder: libjpeg does not build here ({first}) "
                                   "and Pillow is not installed") from exc
            logging.info("libjpeg does not build here (%s); decoding JPEG with Pillow", first)
            picked = "pil"
        _decoder = picked
        logging.info("JPEG decoder: %s", picked)
    return _decoder


def available() -> dict:
    """What was built: {"warp": the warp library's path, "decoder": the JPEG
    decoder's name}. Builds both at first call; a failed build raises."""
    warp = load("imgwarp")
    return {"warp": warp._name, "decoder": decoder()}


_tls = threading.local()  # per-thread scratch: the decode buffer


def decode_jpeg(data: bytes, max_h: int = 1080, max_w: int = 1920, using: str | None = None) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 through `decoder()` (or `using`,
    "libjpeg" or "pil"); a stream that does not decode raises."""
    if (using or decoder()) == "pil":
        from PIL import Image

        try:
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except OSError as exc:
            raise ValueError(f"Pillow JPEG decode failed: {exc} ({len(data)} bytes)") from exc
    lib = load("jpeg_libjpeg")
    out = getattr(_tls, "buf", None)
    if out is None or out.shape[0] < max_h or out.shape[1] < max_w:
        out = _tls.buf = np.empty((max_h, max_w, 3), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_jpeg(data, len(data), out.ctypes.data_as(ctypes.c_void_p), max_h, max_w,
                         ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"libjpeg JPEG decode failed with code {rc} ({len(data)} bytes)")
    # rows are written densely (stride = actual width)
    n = h.value * w.value * 3
    return out.ravel()[:n].reshape(h.value, w.value, 3).copy()


def warp_affine_one(src: np.ndarray, affine: np.ndarray, out_res: tuple[int, int],
                    out_u8: bool = False) -> np.ndarray:
    """Single-image native warp: (H, W[, C]) uint8 -> (out_h, out_w[, C])
    float32 in [0,1] (or rounded uint8 with `out_u8`). The loaders call it
    per sample, on their threads (the GIL is released during the call)."""
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    out = warp_affine_batch(src[None], np.asarray(affine, np.float32)[None], out_res,
                            n_threads=1, out_u8=out_u8)
    return out[0, ..., 0] if squeeze else out[0]


def warp_affine_batch(srcs: np.ndarray, affines: np.ndarray, out_res: tuple[int, int],
                      n_threads: int = 0, out_u8: bool = False) -> np.ndarray:
    """Batched bilinear warp of (B, H, W, C) uint8 by (B, 3, 3) float32
    source -> destination pixel maps; u8 -> f32 [0,1] fused (default) or
    rounded uint8 output (`out_u8`). `n_threads` 0 takes every core."""
    lib = load("imgwarp")
    srcs = np.ascontiguousarray(srcs, np.uint8)
    affines = np.ascontiguousarray(affines, np.float32)
    if srcs.ndim != 4 or affines.shape != (srcs.shape[0], 3, 3):
        raise ValueError(f"warp_affine_batch: srcs {srcs.shape}, affines {affines.shape}")
    b, h, w, c = srcs.shape
    out = np.empty((b, out_res[0], out_res[1], c), np.uint8 if out_u8 else np.float32)
    fn = lib.warp_affine_batch_u8 if out_u8 else lib.warp_affine_batch
    fn(srcs.ctypes.data_as(ctypes.c_void_p), b, h, w, c,
       affines.ctypes.data_as(ctypes.c_void_p),
       out.ctypes.data_as(ctypes.c_void_p), out_res[0], out_res[1], n_threads)
    return out
