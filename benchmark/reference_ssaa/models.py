"""The reference's model with the SSAA renderer (renderer.py) in place of
benchmark.reference's, built from the same tables in the same module slot:
the renderer holds no parameters, so the seeded weights load as they do
into benchmark.reference's model."""

from __future__ import annotations

import torch

from benchmark.reference import resolve_device
from benchmark.reference.config import Config
from benchmark.reference.models import hifihr
from benchmark.reference_ssaa.renderer import PhongRenderer


class HiFiHR(hifihr.HiFiHR):
    def __init__(self, config: Config):
        super().__init__(config)
        if not config.render or config.hand_model == "mano_new":
            return
        settings = self.renderer.settings
        if config.hand_model == "mano":
            self.renderer = PhongRenderer(self.mano.faces_np, self.mano.v_template_np, settings)
        else:
            nb, uv = self.nimble, self.nimble.vert_uv_np is not None
            corner = config.nimble_corner_tex
            self.renderer = PhongRenderer(nb.faces_np, nb.v_template_np, settings,
                                          vert_uv=nb.vert_uv_np, face_uv=nb.face_uv_np if uv else None,
                                          corner_mean=nb.corner_mean_np if corner else None,
                                          corner_basis=nb.corner_basis_np if corner else None)


def build_model(config: Config, device=None) -> HiFiHR:
    """The model in eval mode on `device`, channels-last as the port's; its
    weights are the benchmark's seeded ones, loaded by the caller."""
    return HiFiHR(config).to(resolve_device(device), memory_format=torch.channels_last).eval()
