"""K2 and K3's plain versions (a copy of the port's render/gather.py
`gather_rows_plain` and `scatter_rows_plain`). Both are differentiable as
they stand: autograd's backward of the gather is a scatter-add, and of the
index_add a gather, so no autograd.Function is needed here.

  gather_rows(table (B, F, D), idx (B, P)) -> (B, P, D)
      out[b, p, :] = table[b, idx[b, p], :], zeros where idx lies outside [0, F)
  scatter_rows(values (B, P, D), idx (B, P), n_rows) -> (B, n_rows, D)
      out[b, f, :] = sum over p with idx[b, p] == f of values[b, p, :]
"""

from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, F, D = table.shape
    ok = (idx >= 0) & (idx < F)
    safe = torch.where(ok, idx, torch.zeros_like(idx)).long()
    rows = torch.gather(table, 1, safe.unsqueeze(-1).expand(B, idx.shape[1], D))
    return torch.where(ok.unsqueeze(-1), rows, torch.zeros((), dtype=table.dtype, device=table.device))


def scatter_rows(values: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    B, P, D = values.shape
    ok = (idx >= 0) & (idx < n_rows)
    base = torch.arange(B, device=idx.device)[:, None] * n_rows
    dst = torch.where(ok, idx.long() + base, torch.full_like(base, B * n_rows))
    out = values.new_zeros((B * n_rows + 1, D))
    out = out.index_add(0, dst.reshape(-1), values.reshape(B * P, D))
    return out[:-1].reshape(B, n_rows, D)
