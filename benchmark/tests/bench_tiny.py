"""A cell at a size the CPU runs in seconds: the flagship's or the paper's
layers (ResNet-18 or EfficientNet-b3, MANO or NIMBLE) at 32 px, built
from the real cell's files with only its sizes changed, so the lookup, the
loop and the check are the real ones."""

from __future__ import annotations

import copy

from benchmark import spec

TINY = {"image_size": 32, "light_estimation": False, "compute_dtype": "float32", "train_batch": 4,
        "val_batch": 2}


def tiny_cell(name: str, here: str = spec.HERE, **over) -> spec.Cell:
    cell = copy.deepcopy(spec.find_cell(name, here=here))
    cell.config.update(TINY, **over)
    if cell.config.get("pretrain") == "res50":
        cell.config["pretrain"] = "res18"
    cell.traffic["pool_batches"] = 4
    cell.traffic["scene"]["focal_px"] = [60.0, 70.0]
    return cell
