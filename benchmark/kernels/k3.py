"""K3, the row scatter-add (hifihr_tpu_torch/render/gather.py `_scatter`,
csrc/scatter_rows.cu; K2's backward): the fill of its zeroed output right
before `scatter_rows_kernel`, one launch a call.

A call keeps its values' shape, its row index by reference and its row
count. Its least time (roofline.k3_bound_s): the index, the covered pixels'
rows read and the whole output written, or one add per covered element
where that takes longer."""

from benchmark import roofline

WRAPS = ("hifihr_tpu_torch.render.gather", "_scatter")
TRACE = (("scatter_rows_kernel", ("Fill", "Memset")),)


def record(values, idx, n_rows):
    return tuple(values.shape), idx, n_rows


def bound_s(call) -> float:
    shape, idx, n_rows = call
    return roofline.k3_bound_s(shape, idx, n_rows)
