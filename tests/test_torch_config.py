"""The port's Config against the JAX package's on every shipped config file
(configs/**/*.json): the same 90 fields and defaults, the same loader, and
the same warning on keys neither models. All 45 files build, the two that
set hand_model "mano_new" (the YTBHand baseline) among them; a value the
port cannot run as the JAX package does raises NotImplementedError.
"""

import dataclasses
import glob
import os
import warnings

import pytest

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu_torch.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.json"),
                                                              recursive=True))
MANO_NEW = {"configs/FreiHAND/fully_superv_freihand_mano_new.json",
            "configs/FreiHAND/fully_superv_freihand_mano_new_back.json"}


def _load(cls, path, **overrides):
    """(config or the NotImplementedError it raised, the loader's warnings)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            cfg = cls.from_json(os.path.join(ROOT, path), **overrides)
        except NotImplementedError as e:
            cfg = e
    return cfg, [str(w.message) for w in caught if "not modelled" in str(w.message)]


def test_fields_and_defaults_are_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(Config)] == jf
    assert len(jf) == 90
    assert Config().to_dict() == JConfig().to_dict()
    assert len(SHIPPED) == 45 and MANO_NEW <= set(SHIPPED)


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_config(path):
    jcfg, jwarn = _load(JConfig, path)
    cfg, warn = _load(Config, path)
    assert isinstance(cfg, Config), cfg
    if path in MANO_NEW:
        assert cfg.hand_model == "mano_new" and not cfg.render
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.ncomps == jcfg.ncomps
    for name in ("j2d_gt", "shape", "pose", "tex_reg"):
        for epoch in (0, 15, 275, 1000):
            assert cfg.lambda_at_epoch(name, epoch) == jcfg.lambda_at_epoch(name, epoch)
    assert warn == jwarn


def test_overrides_and_unported_values():
    """from_json's overrides replace the file's keys; lists become tuples;
    each value the port would compute differently raises, naming it."""
    path = "configs/FreiHAND/full_rhd_freihand.json"
    over = dict(image_size=32, light_estimation=False, compute_dtype="float32", lr_steps=[1, 2])
    cfg, _ = _load(Config, path, **over)
    jcfg, _ = _load(JConfig, path, **over)
    assert cfg.to_dict() == jcfg.to_dict() and cfg.lr_steps == (1, 2)
    assert (cfg.pretrain, cfg.hand_model, cfg.base_loss_fn, cfg.train_batch, cfg.val_batch) == (
        "effb3", "nimble", "L1", 48, 16)
    err, _ = _load(Config, path, losses=["no_such_loss"])
    assert isinstance(err, NotImplementedError) and "no_such_loss" in str(err), err
    # NIMBLE's UV and SSAA render paths, the test-time fit, the DP x FSDP
    # mesh, the rgb2hm branch, HRNet, the four-channel input and
    # pretrain="none" (which the model refuses, as JAX's does) build, as in
    # the JAX package
    for good in (dict(test_refinement=True), dict(aa_mode="ssaa"), dict(nimble_corner_tex=False), dict(fsdp=2),
                 dict(rgb2hm=True), dict(freeze_hm_estimator=True), dict(rgb2hm=True, freeze_hm_estimator=True),
                 dict(four_channel=True), dict(pretrain="hr18sv2"), dict(pretrain="none")):
        cfg, _ = _load(Config, path, **good)
        jcfg, _ = _load(JConfig, path, **good)
        assert isinstance(cfg, Config) and cfg.to_dict() == jcfg.to_dict(), good
    # the imagenet warm start is ported (hifihr_tpu_torch/utils/weights.py)
    cfg, _ = _load(Config, path, encoder_imagenet_npz="x.npz")
    assert cfg.encoder_imagenet_npz == "x.npz"
    for bad in (dict(pretrain="effb7"), dict(hand_model="ytb"), dict(train_datasets=["COCO"])):
        with pytest.raises(ValueError):
            Config.from_dict(bad)
        with pytest.raises(ValueError):
            JConfig.from_dict(bad)
