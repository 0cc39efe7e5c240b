"""K2: batched per-pixel row gather.

Counterpart of hifihr_tpu/render/gather_mxu.py::gather_rows (the Pallas TPU
kernel `_fwd_kernel`, a hi/lo bf16 one-hot matmul good to about 2^-16).
Contract: out[b, p, :] = table[b, idx[b, p], :], zeros where idx lies
outside [0, F) (the renderer passes -1 for background). Here the gather is a
direct fp32 copy, so it is exact.

  gather_rows_plain  plain PyTorch version
  gather_rows        the wrapper: the CUDA kernel csrc/gather_rows.cu for a
                     CUDA tensor, the plain version for a CPU tensor

The wrapper is forward-only on the card: its backward is the scatter-add
kernel (K3, gather_mxu.py::_bwd_kernel), which the training slice ports.
"""

from __future__ import annotations

import torch

from hifihr_tpu_torch import kernels


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, F, D), idx (B, P) int -> (B, P, D); zeros where idx is
    outside [0, F)."""
    B, F, D = table.shape
    ok = (idx >= 0) & (idx < F)
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()
    rows = torch.gather(table, 1, safe.unsqueeze(-1).expand(B, idx.shape[1], D))
    return torch.where(ok.unsqueeze(-1), rows, torch.zeros((), dtype=table.dtype, device=table.device))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2. A CUDA tensor goes through the CUDA kernel (or raises); a CPU
    tensor through the plain version. Counts kernel launches on
    `gather_rows.launches`."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "gather_rows on CUDA is forward-only: its backward is the scatter-add kernel "
            "K3 (hifihr_tpu/render/gather_mxu.py::_bwd_kernel), ported with the training slice")
    if idx.device != table.device:
        raise ValueError("table and idx must be on the same device")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"need float32 table and int32 idx, got {table.dtype}, {idx.dtype}")
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"bad shapes table {tuple(table.shape)} idx {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    B, F, D = table.shape
    P = idx.shape[1]
    if F * D >= 2**31 or 256 * D >= 2**31 or B > 65535:
        raise ValueError(f"shape (B={B}, F={F}, D={D}) outside the kernel's range")
    lib = kernels.load("gather_rows")
    out = torch.empty((B, P, D), dtype=torch.float32, device=table.device)
    err = lib.hifihr_gather_rows(table.data_ptr(), idx.data_ptr(), B, F, D, P,
                                 out.data_ptr(), kernels.stream_ptr(table.device))
    kernels.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
