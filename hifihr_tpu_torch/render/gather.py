"""K2 and K3: batched per-pixel row gather and its transpose, a segment sum.

Counterparts of hifihr_tpu/render/gather_mxu.py::gather_rows and
scatter_rows (the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel`, hi/lo
bf16 one-hot matmuls good to about 2^-16). Contracts:

  gather_rows(table (B, F, D), idx (B, P)) -> (B, P, D)
      out[b, p, :] = table[b, idx[b, p], :], zeros where idx lies outside
      [0, F) (the renderer passes -1 for background). Its gradient with
      respect to the table is scatter_rows.
  scatter_rows(values (B, P, D), idx (B, P), n_rows) -> (B, n_rows, D)
      out[b, f, :] = sum over p with idx[b, p] == f of values[b, p, :], rows
      with idx outside [0, n_rows) dropped. Its gradient with respect to the
      values is gather_rows.

Both are `torch.autograd.Function`s. A CUDA tensor goes through the CUDA
kernels (csrc/gather_rows.cu, K2, an exact fp32 copy; csrc/scatter_rows.cu,
K3, fp32 atomics, so its last bits vary from run to run) or raises; a CPU
tensor through the plain versions `gather_rows_plain` and
`scatter_rows_plain`, with the same autograd wiring.
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


def scatter_rows_plain(values: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """values (B, P, D), idx (B, P) int -> (B, n_rows, D): an `index_add_`
    over the flattened (B * n_rows) table, rows with idx outside [0, n_rows)
    sent to one extra row that is dropped."""
    B, P, D = values.shape
    ok = (idx >= 0) & (idx < n_rows)
    base = torch.arange(B, device=idx.device)[:, None] * n_rows
    dst = torch.where(ok, idx.long() + base, torch.full_like(base, B * n_rows))
    out = values.new_zeros((B * n_rows + 1, D))
    out.index_add_(0, dst.reshape(-1), values.reshape(B * P, D))
    return out[:-1].reshape(B, n_rows, D)


def _check_cuda(what: str, rows: torch.Tensor, idx: torch.Tensor) -> None:
    if idx.device != rows.device:
        raise ValueError(f"{what}: tensor and idx must be on the same device")
    if rows.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"{what}: need float32 rows and int32 idx, got {rows.dtype}, {idx.dtype}")
    if rows.dim() != 3 or idx.dim() != 2 or idx.shape[0] != rows.shape[0]:
        raise ValueError(f"{what}: bad shapes {tuple(rows.shape)} and idx {tuple(idx.shape)}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what}: tensor and idx must be contiguous")


def _check_range(what: str, B: int, F: int, D: int) -> None:
    if F * D >= 2**31 or 256 * D >= 2**31 or B > 65535:
        raise ValueError(f"{what}: shape (B={B}, F={F}, D={D}) outside the kernel's range")


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    _check_cuda("gather_rows", table, idx)
    B, F, D = table.shape
    P = idx.shape[1]
    _check_range("gather_rows", B, F, D)
    lib = kernels.load("gather_rows")
    out = torch.empty((B, P, D), dtype=torch.float32, device=table.device)
    err = lib.hifihr_gather_rows(table.data_ptr(), idx.data_ptr(), B, F, D, P,
                                 out.data_ptr(), kernels.stream_ptr(table.device))
    kernels.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


def _scatter(values: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    if values.device.type == "cpu":
        return scatter_rows_plain(values, idx, n_rows)
    if values.device.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {values.device}")
    _check_cuda("scatter_rows", values, idx)
    B, P, D = values.shape
    _check_range("scatter_rows", B, n_rows, D)
    lib = kernels.load("scatter_rows")
    out = torch.zeros((B, n_rows, D), dtype=torch.float32, device=values.device)
    err = lib.hifihr_scatter_rows(values.data_ptr(), idx.data_ptr(), B, n_rows, D, P,
                                  out.data_ptr(), kernels.stream_ptr(values.device))
    kernels.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[1]
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g.contiguous(), idx, ctx.n_rows), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, n_rows):
        ctx.save_for_backward(idx)
        return _scatter(values, idx, n_rows)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows(g.contiguous(), idx), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2, differentiable in `table` (its backward is K3). Counts K2 kernel
    launches on `gather_rows.launches`."""
    return _GatherRows.apply(table, idx)


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K3, differentiable in `values` (its backward is K2). Counts K3 kernel
    launches, the backward of gather_rows included, on
    `scatter_rows.launches`."""
    return _ScatterRows.apply(values, idx, n_rows)


gather_rows.launches = 0
scatter_rows.launches = 0
