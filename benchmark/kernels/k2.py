"""K2, the row gather (hifihr_tpu_torch/render/gather.py `_gather`,
csrc/gather_rows.cu): `gather_rows_kernel`, one launch a call.

A call keeps its table's shape and its row index by reference. Its least
time is its bytes (roofline.k2_bound_s): the distinct rows the index reads,
the index and the output."""

from benchmark import roofline

WRAPS = ("hifihr_tpu_torch.render.gather", "_gather")
TRACE = (("gather_rows_kernel", ()),)


def record(table, idx):
    return tuple(table.shape), idx


def bound_s(call) -> float:
    shape, idx = call
    return roofline.k2_bound_s(shape, idx)
