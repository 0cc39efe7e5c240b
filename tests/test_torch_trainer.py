"""The port's Trainer (hifihr_tpu_torch/training/loop.py), its warm start and
its entry (hifihr_tpu_torch/train.py) against the JAX package's on the CPU.

Both Trainers run the smoke_render config's losses at the slice tests' size
(res18, 32 px, 3x3 MSAA, no light estimation, fp32, batch 8) on the
synthetic stand-in (16 training samples, 12 val samples: a ragged last val
batch of 4). The port starts from the JAX Trainer's own init state,
converted. The JAX side runs on a one-device mesh, jitted, with its MSAA
face choice op by op (tests/torch_port_helpers.py::jax_msaa_select_op_by_op,
as in tests/test_torch_train_slice.py).

Tolerances:
- `evaluate()` of the untrained state: every number 1e-4 relative (the
  2D-error means too); the dumped predictions 1e-6 m absolute;
- epoch 0's logged terms at steps 0 and 1: 1e-4 relative, 1e-9 absolute,
  for the total and the geometric terms (measured 6e-6 at most); 2e-3 for
  the photometric terms (texture, mrgb, ssim_tex and their _self forms;
  measured 7.4e-4 at most, ssim_tex_self at step 1). Those read the binary
  silhouette, where a face edge moves with the vertices' last bits: JAX
  against itself, with its input images moved by one ulp, moves
  ssim_tex_self by 2.5e-4 at the first step on the first synthetic batch.
  The run trains at lr 1e-5, not smoke_render's 1e-3: Adam's first update
  is about lr * sign(g), so gradient entries at the rounding level move
  their weights by +-lr whichever way they round, and at lr 1e-3 JAX
  against itself (one ulp of input) differs at step 1 by 3.0e-4 in the
  total and 6.6e-3 in ssim_tex_self;
- epoch 1 (steps 2-3): 1e-2 on the total and the mpose term (measured
  9.2e-4); the λ_pose step from 1e-4 to 1e-2 at epoch 1 shows in both, as
  a jump of the mpose term over 10x;
- resume and the warm start: bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import hifihr_tpu.training.loop as jloop
from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.data.base import BatchLoader as JBatchLoader
from hifihr_tpu.data.synthetic import SyntheticHandDataset as JSynthetic
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.parallel.mesh import make_mesh as jmake_mesh
from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
from hifihr_tpu.utils.weights import merge_npz_into_variables
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.data.base import BatchLoader
from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.training.loop import Trainer
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import jax_msaa_select_op_by_op, numpy_tree
from tests.test_ho3d import ho3d_root  # noqa: F401 - fixture
from tests.test_real_loaders import dart_root, rhd_root  # noqa: F401 - fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B, N_TRAIN, N_VAL = 32, 8, 16, 12
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "texture", "mrgb",
          "ssim_tex")  # configs/smoke_render.json
PHOTOMETRIC = ("texture", "mrgb", "ssim_tex", "texture_self", "mrgb_self", "ssim_tex_self")
CFG = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=S, aa_factor=3,
           compute_dtype="float32", losses=LOSSES, base_loss_fn="L1", lambda_j3d=200, lambda_vert_3d=150,
           lambda_silhouette=0.05, lambda_texture=0.02, lambda_mrgb=0.002, lambda_ssim_tex=0.01,
           lambda_pose_list=(1e-4, 1e-2), lambda_pose_steps=(1,), init_lr=1e-5, lr_steps=(1,), lr_gamma=0.5,
           train_batch=B, val_batch=B, print_freq=1, demo_freq=10000, save_mode="only_latest", num_workers=2,
           save_2d=True, save_3d=True)


def _loaders(ds_cls, loader_cls, train_ds=None):
    train = loader_cls(train_ds or ds_cls(size=N_TRAIN, image_size=S), B, num_workers=2)
    val = loader_cls(ds_cls(size=N_VAL, image_size=S, seed=5), B, shuffle=False, drop_last=False)
    return train, val, {"xyz": val.dataset.joints, "verts": val.dataset.verts}


def _log(path):
    with open(os.path.join(path, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each Trainer's untrained evaluate() and two epochs of two steps; the
    JAX Trainer's init variables; the port's Trainer and its out dir."""
    base = tmp_path_factory.mktemp("trainer")
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces_msaa", jax_msaa_select_op_by_op)
    mp.setattr(jloop, "make_mesh", lambda fsdp=1: jmake_mesh(n_devices=1))
    try:
        jcfg = JConfig(**CFG, base_out_path=str(base / "jax"))
        jtrain, jval, gt = _loaders(JSynthetic, JBatchLoader)
        jt = jloop.Trainer(jcfg, JModel(config=jcfg), jtrain, jval, eval_gt=gt, out_dir=jcfg.base_out_path)
        init = numpy_tree({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
        assert jtrain.epoch == 1  # the init draw moved the loader to its next epoch
        jeval = jt.evaluate(-1)
        jt.train_epoch(0)
        jt.train_epoch(1)
    finally:
        mp.undo()

    cfg = Config(**CFG, base_out_path=str(base / "port"))
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(init), strict=True)
    train, val, gt = _loaders(SyntheticHandDataset, BatchLoader)
    trainer = Trainer(cfg, model, train, val, eval_gt=gt, out_dir=cfg.base_out_path)
    assert train.epoch == 1  # as the JAX Trainer's
    ev = trainer.evaluate(-1)
    trainer.train_epoch(0)
    trainer.train_epoch(1)
    return {"jax_eval": jeval, "eval": ev, "jax_log": _log(jcfg.base_out_path), "log": _log(cfg.base_out_path),
            "init": init, "trainer": trainer}


def _steps(log, epoch):
    return [r for r in log if r.get("epoch") == epoch and "step" in r]


def test_untrained_evaluate(runs):
    """Every metric, the 2D-error report's means (save_2d) and the
    predictions dumped to json/pred_-1.json (save_3d)."""
    ev, jev = dict(runs["eval"]), dict(runs["jax_eval"])
    assert set(ev) == set(jev) and {"pa_mpjpe_cm", "pa_mpvpe_cm", "pck_auc", "tex_psnr", "tex_ssim", "j2d_errors_px",
                                    "pred_json"} <= set(ev)
    with open(ev.pop("pred_json")) as f, open(jev.pop("pred_json")) as g:
        (xyz, verts), (jxyz, jverts) = json.load(f), json.load(g)
    assert np.shape(xyz) == (N_VAL, 21, 3) and np.shape(verts) == (N_VAL, 778, 3)
    np.testing.assert_allclose(xyz, jxyz, rtol=0, atol=1e-6)
    np.testing.assert_allclose(verts, jverts, rtol=0, atol=1e-6)
    errs, jerrs = ev.pop("j2d_errors_px"), jev.pop("j2d_errors_px")
    assert set(errs) == set(jerrs) == {"proj", "detect"}
    for k in errs:
        np.testing.assert_allclose(errs[k], jerrs[k], rtol=1e-4, err_msg=k)
    for k, v in jev.items():
        if isinstance(v, str):
            assert ev[k] == v, k
        else:
            np.testing.assert_allclose(ev[k], v, rtol=1e-4, err_msg=k)


def test_epoch_0_logged_terms(runs):
    mine, ref = _steps(runs["log"], 0), _steps(runs["jax_log"], 0)
    assert [r["step"] for r in mine] == [r["step"] for r in ref] == [0, 1]
    for a, b in zip(mine, ref):
        terms = set(b) - {"epoch", "step", "batch_time"}
        assert set(a) - {"epoch", "step", "batch_time"} == terms and len(terms) == len(LOSSES) + 6  # the _self triple, loss, total, skipped
        for k in terms:
            rtol = 2e-3 if k in PHOTOMETRIC else 1e-4
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-9, err_msg=(a["step"], k))


def test_lambda_schedule_crosses_the_epoch_boundary(runs):
    """λ_pose steps from 1e-4 to 1e-2 at epoch 1 (make_sched once per
    epoch): the mpose term jumps in both packages alike, and the epoch
    records count every step taken."""
    for log in (runs["log"], runs["jax_log"]):
        e0, e1 = _steps(log, 0), _steps(log, 1)
        assert [r["step"] for r in e1] == [0, 1]
        assert e1[0]["mpose"] > 10 * e0[-1]["mpose"] > 0
        recs = [r for r in log if "train_loss" in r]
        assert [r["epoch"] for r in recs] == [0, 1] and all(r["skipped_steps"] == 0 for r in recs)
    for a, b in zip(_steps(runs["log"], 1), _steps(runs["jax_log"], 1)):
        np.testing.assert_allclose(a["total"], b["total"], rtol=1e-2)
        np.testing.assert_allclose(a["mpose"], b["mpose"], rtol=1e-2)


def test_resume_continues_at_the_next_epoch(runs, tmp_path):
    """A checkpoint of epoch 1 resumes at epoch 2 with the saved state, bit
    for bit, and fit() trains only the epochs after it."""
    trainer = runs["trainer"]
    trainer.ckpt.save(trainer.state, 1)
    opt = trainer.state.optimizer
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    moments = (opt.mu.clone(), opt.nu.clone(), opt.count.clone())
    assert int(opt.count) == 4

    cfg = Config(**CFG, base_out_path=str(tmp_path), total_epochs=3,
                 pretrain_model=os.path.join(trainer.out_dir, "model"))
    model = HiFiHR(cfg)
    train, val, gt = _loaders(SyntheticHandDataset, BatchLoader)
    resumed = Trainer(cfg, model, train, val, eval_gt=gt, out_dir=str(tmp_path))
    assert resumed.start_epoch == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    ropt = resumed.state.optimizer
    for a, b in zip((ropt.mu, ropt.nu, ropt.count), moments):
        assert torch.equal(a, b)
    assert torch.equal(ropt.flat, opt.flat)
    resumed.fit()
    log = _log(str(tmp_path))
    assert [r["epoch"] for r in log if "train_loss" in r] == [2] and int(ropt.count) == 6
    assert any("eval" in r and r["epoch"] == 2 for r in log)
    assert os.path.exists(os.path.join(str(tmp_path), "model", "texturehand_latest.pt"))


def test_imagenet_warm_start_matches_the_jax_merge(runs, tmp_path):
    """An npz in tools/convert_torch_weights.py's key layout (backbone-
    relative paths: the s2d stem, a block's conv and BatchNorm, running
    stats, and one key of a wrong shape, which is skipped) lands where JAX's
    merge_npz_into_variables puts it."""
    init = runs["init"]
    bb = init["params"]["encoder"]["backbone"]
    rng = np.random.RandomState(0)

    def noise(a):
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    z = {"params/conv1/kernel": noise(bb["conv1"]["kernel"]),
         "params/layer2_0/conv2/kernel": noise(bb["layer2_0"]["conv2"]["kernel"]),
         "params/layer2_0/bn2/scale": noise(bb["layer2_0"]["bn2"]["scale"]),
         "params/layer3_1/downsample_conv/kernel": np.zeros((1, 1, 3, 3), np.float32),  # no such shape
         "params/layer4_1/conv1/kernel": np.zeros((3, 3, 512, 7), np.float32),  # wrong shape: skipped
         "batch_stats/layer1_1/bn1/mean": noise(init["batch_stats"]["encoder"]["backbone"]["layer1_1"]["bn1"]["mean"]),
         "batch_stats/bn1/var": 1.0 + np.abs(noise(init["batch_stats"]["encoder"]["backbone"]["bn1"]["var"]))}
    path = str(tmp_path / "imagenet_res18.npz")
    np.savez(path, **z)
    want = state_dict_from_flax(numpy_tree(merge_npz_into_variables(path, init)))

    cfg = Config(**CFG, encoder_imagenet_npz=path)
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(init), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    create_train_state(model, cfg)
    changed = 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
        changed += not torch.equal(v, before[k])
    assert changed == 5


def test_entry_trains_and_evaluates_smoke_synthetic(tmp_path, rhd_root, ho3d_root, dart_root):
    """`python -m hifihr_tpu_torch.train --config_json
    configs/smoke_synthetic.json --device cpu`, its out dir moved into
    tmp_path: one epoch, a checkpoint, an eval; then --mode evaluation.
    A config naming RHD, HO-3D or DART trains on that dataset's loader,
    read from its path (the JAX tests' fixture trees)."""
    from hifihr_tpu_torch.data.dart import DARTset
    from hifihr_tpu_torch.data.ho3d import HO3D
    from hifihr_tpu_torch.data.rhd import RHD
    from hifihr_tpu_torch.train import build_loaders, main

    with open(os.path.join(ROOT, "configs", "smoke_synthetic.json")) as f:
        raw = json.load(f)
    raw["base_out_path"] = str(tmp_path / "out")
    cfg_path = str(tmp_path / "smoke_synthetic.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    best = main(["--config_json", cfg_path, "--device", "cpu"])
    log = _log(raw["base_out_path"])
    epochs = [r for r in log if "train_loss" in r]
    assert len(epochs) == 1 and epochs[0]["skipped_steps"] == 0 and np.isfinite(epochs[0]["train_loss"])
    ev = [r["eval"] for r in log if "eval" in r]
    assert len(ev) == 1 and np.isfinite(ev[0]["pa_mpjpe_cm"]) and best == ev[0]["pa_mpjpe_cm"]
    assert os.path.exists(os.path.join(raw["base_out_path"], "model", "texturehand_latest.pt"))
    with open(os.path.join(raw["base_out_path"], "train.log")) as f:
        assert "config: Config(" in f.read()
    result = main(["--config_json", cfg_path, "--device", "cpu", "--mode", "evaluation"])
    assert result["pa_mpjpe_cm"] == pytest.approx(ev[0]["pa_mpjpe_cm"], rel=0.5)
    paths = dict(rhd_base_path=rhd_root, ho3d_base_path=ho3d_root[0], dart_base_path=dart_root)
    for name, cls in (("RHD", RHD), ("HO3D", HO3D), ("Dart", DARTset)):
        train_loader, _ = build_loaders(Config(**dict(CFG, train_datasets=(name,), train_batch=1, **paths)))
        assert type(train_loader.dataset) is cls and train_loader.dataset.name == name
        assert np.isfinite(next(iter(train_loader))["joints"]).all()
