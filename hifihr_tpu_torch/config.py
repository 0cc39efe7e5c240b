"""The port's configuration: the fields of hifihr_tpu/config.py::Config that
the ported slice reads, with the same names and defaults, so one dict builds
both."""

from __future__ import annotations

from dataclasses import dataclass

ENCODERS = ("res18", "res50", "res101")


@dataclass(frozen=True)
class Config:
    pretrain: str = "res50"
    hand_model: str = "mano"
    use_mean_shape: bool = False
    render: bool = True
    light_estimation: bool = True
    image_size: int = 224
    aa_factor: int = 3
    # 'msaa': the rasteriser tests aa_factor x aa_factor subsamples per pixel
    # and shading runs once per pixel
    aa_mode: str = "msaa"
    # encoder compute dtype; parameters stay float32
    compute_dtype: str = "bfloat16"
    rgb2hm: bool = False

    def __post_init__(self):
        if self.pretrain not in ENCODERS:
            raise ValueError(f"pretrain={self.pretrain!r}: the port has {ENCODERS}")
        if self.hand_model != "mano":
            raise NotImplementedError(f"hand_model={self.hand_model!r}: the port has 'mano' only")
        if self.aa_mode != "msaa":
            raise NotImplementedError(f"aa_mode={self.aa_mode!r}: the port has 'msaa' only")
        if self.rgb2hm:
            raise NotImplementedError("rgb2hm: the heatmap branch is not ported")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}")

    @property
    def ncomps(self):
        """(shape, pose, tex) component counts (models_res_nimble.py:55-60)."""
        return (10, 48, None)
