"""Multi-rank training in the port (hifihr_tpu_torch/parallel/, the global
BatchNorm statistics, the loss shares, the skip guard, the flat-gradient
reduction and fsdp's sharded Adam, the Trainer and the entry at N ranks)
against one rank and against the JAX package's 2-device mesh, on the CPU.

Ranks are processes spawned by hifihr_tpu_torch.parallel.launch.spawn_ranks
under gloo, one intra-op thread each, meeting on a file store under the
test's tmp_path (no TCP port, so concurrent test workers never collide);
every collective times out after 120 s and every run after 300 s, so a hung
rendezvous fails its test. The rank targets are in tests/torch_port_helpers.py
and import no JAX.

The configuration is the slice tests' (res18, 32 px, 3x3 MSAA, fp32, Adam at
lr 1e-3) at a global batch of 8 whose rows differ in every key
(torch_port_helpers.varied_batch), with the flagship losses plus open_2dj,
both photometric triples and the rgb2hm branch with hm_integral, so all four
ratio terms (open_2dj, hm_integral, texture_self, mrgb_self) and mrgb's
square of a global mean fire, and so no wrong per-rank reduction can cancel
out between the ranks.

Tolerances:
- every term and the total at step 1, and the total at step 2: 1e-4
  relative (measured 3e-6 and 3e-6 at world 2 and 4). The terms at step 2:
  1e-2. From the second step the run is chaotic, as in every slice test
  (ROADMAP.md section 3): Adam's first update is about lr * sign(g), and
  the gradients that are zero in exact arithmetic (the Linear biases before
  a train-mode BatchNorm, every hourglass bias) are rounding noise whose
  sign differs between any two reduction orders; mscale, the mean of
  |bone - 0.0282| over bones near 0.0282, amplifies it (measured 2.3e-3
  and 3.2e-3 at world 2 and 4);
- the parameters after two steps: bitwise equal across the ranks;
- the global BatchNorm against one rank on the concatenated batch: outputs,
  running statistics and input gradients within 1e-6 (measured 4.8e-7 at
  activations of ~10), scale and bias gradients within 1e-6 relative;
- the port at 2 ranks against JAX's make_train_step on make_mesh(2), at
  lr 1e-5 as tests/test_torch_trainer.py trains (there the chaos of the
  first update stays below the tolerance): every term at steps 1 and 2
  within 1e-4 relative (measured 6.7e-5 at most, mscale at step 2; at lr
  1e-3 the step-2 total differs by 1.6e-4), the ranks shading JAX's MSAA
  face choice (each rank its
  rows of it) and their own choice held at >= 99.5% of pixels at step 1
  (measured 99.98%), as in the NIMBLE slice tests: the photometric terms
  read the binary silhouette, whose edge moves with the vertices' last bits
  (that one pixel moved mrgb_self by 2.7e-4). At step 2 the hand comes from
  the chaotic first update, and the own choice is held at >= 95% (measured
  98.1%);
- the Trainer's eval at 2 ranks against a one-rank eval of the same
  checkpoint: 1e-5 relative (the one-rank eval runs in this process, with
  its own intra-op thread count); the same weights evaluated at 1 and 2
  spawned ranks, one thread each: equal to the bit, since each rank
  evaluates whole batches at a one-rank eval's shapes.
"""

import json
import os

import numpy as np
import pytest
import torch

from hifihr_tpu_torch.parallel.launch import spawn_ranks
from torch_port_helpers import bn_rank, dp_suite_rank, dp_train_rank, entry_rank, varied_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 32
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou", "bone_direc",
          "open_2dj", "hm_integral")
CFG = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=S,
           aa_factor=3, aa_mode="msaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3, rgb2hm=True)
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")


def _spawn(target, world, args, tmp_path):
    return spawn_ranks(target, world, args, backend="gloo", device="cpu", timeout_s=300,
                       collective_timeout_s=120, workdir=str(tmp_path))


def _nan_batch() -> dict:
    """Rank 1's rows (of 2) carry a non-finite target."""
    batch = varied_batch(B, S)
    batch["joints"][B // 2:] = np.nan
    return batch


@pytest.fixture(scope="module")
def one_rank():
    """Two steps at one rank, in this process, without a process group."""
    return dp_train_rank(0, 1, "cpu", CFG, varied_batch(B, S))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """runs(world) -> (each rank's dp, fsdp 2 and, at world 2, skip-guard
    runs, the fsdp checkpoint's directory): one spawn a world size, made
    at its first use (torch_port_helpers.dp_suite_rank)."""
    cache = {}

    def runs(world: int):
        if world not in cache:
            tmp = tmp_path_factory.mktemp(f"world{world}")
            ckpt = str(tmp / "ckpt")
            cache[world] = _spawn(dp_suite_rank, world, (CFG, varied_batch(B, S), ckpt,
                                                         _nan_batch() if world == 2 else None), tmp), ckpt
        return cache[world]

    return runs


def _check_against(runs: list, ref: dict) -> None:
    for r in runs:
        assert r["step"] == 2
        torch.testing.assert_close(r["flat"], runs[0]["flat"], rtol=0, atol=0)  # bitwise, across ranks
        for step in range(2):
            got, want = r["losses"][step], ref["losses"][step]
            assert set(got) == set(want) == set(FIRED) | {"skipped"}
            assert got["skipped"] == want["skipped"] == 0.0
            for k in FIRED:
                assert want[k] != 0.0, k
                rtol = 1e-4 if step == 0 or k == "total" else 1e-2
                np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
    assert not torch.equal(runs[0]["flat"], ref["flat0"])


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_one_rank(world, one_rank, ranks):
    """The same global batch at 1 rank and at `world` ranks: the same terms
    and total, and the same parameters on every rank."""
    _check_against([r["dp"] for r in ranks(world)[0]], one_rank)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_matches_one_rank(world, one_rank, ranks):
    """fsdp 2 at world 2 (fsdp alone) and world 4 (data 2 x fsdp 2): each
    rank keeps a half of Adam's moments and all ranks the whole
    parameters, equal to one rank's. The checkpoint saved under fsdp 2
    holds the moments whole, and restores at world 1 with identical
    moments and count."""
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.checkpoint import CheckpointManager
    from hifihr_tpu_torch.training.train_state import create_train_state

    all_runs, ckpt = ranks(world)
    runs = [r["fsdp"] for r in all_runs]
    _check_against(runs, one_rank)
    for r in runs:
        torch.testing.assert_close(r["mu"], runs[0]["mu"], rtol=0, atol=0)
    n = runs[0]["flat"].numel()
    assert runs[0]["mu"].numel() == n
    config = Config(**CFG)
    state = create_train_state(build_model(config, device="cpu"), config)
    _, epoch = CheckpointManager(ckpt, "only_latest").restore(state)
    assert epoch == 0 and int(state.step) == 2
    torch.testing.assert_close(state.optimizer.mu, runs[0]["mu"], rtol=0, atol=0)
    torch.testing.assert_close(state.optimizer.nu, runs[0]["nu"], rtol=0, atol=0)
    torch.testing.assert_close(state.optimizer.flat, runs[0]["flat"], rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_global_batchnorm_matches_concatenated_batch(world, tmp_path):
    """BatchNorm2d in train mode at `world` ranks against one rank on the
    concatenated batch, whose rows differ in scale and offset."""
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(8, 6, 5, 5, generator=gen) * torch.linspace(0.5, 3, 8)[:, None, None, None]
         + torch.arange(8.0)[:, None, None, None])
    g = torch.randn(8, 6, 5, 5, generator=gen)
    ref = bn_rank(0, 1, "cpu", x, g, 0.99)
    runs = _spawn(bn_rank, world, (x, g, 0.99), tmp_path)
    for k in ("out", "grad_x"):
        torch.testing.assert_close(torch.cat([r[k] for r in runs]), ref[k], rtol=0, atol=1e-6)
    for r in runs:
        torch.testing.assert_close(r["running_mean"], ref["running_mean"], rtol=0, atol=1e-6)
        torch.testing.assert_close(r["running_var"], ref["running_var"], rtol=0, atol=1e-6)
        torch.testing.assert_close(r["grad_params"], ref["grad_params"], rtol=1e-6,
                                   atol=1e-6 * ref["grad_params"].abs().max().item())


def test_skip_guard_decides_on_the_global_total(ranks):
    """Rank 1's rows alone carry a non-finite target: the global total is
    not finite, so both ranks skip the step, and no parameter, moment or
    count moves on either."""
    runs = [r["skip"] for r in ranks(2)[0]]
    assert len(runs) == 2
    for r in runs:
        assert r["step"] == 0
        assert len(r["losses"]) == 1 and all(d["skipped"] == 1.0 and not np.isfinite(d["total"])
                                             for d in r["losses"])
        torch.testing.assert_close(r["flat"], r["flat0"], rtol=0, atol=0)
        assert not r["mu"].any() and not r["nu"].any()


def test_dp_matches_jax_two_device_mesh(tmp_path):
    """The port at 2 ranks against JAX's make_train_step on make_mesh(2)
    (replicate, shard_batch; the 8 virtual CPU devices of conftest.py), from
    the same converted weights, JAX's MSAA face choice run op by op."""
    import jax
    import jax.numpy as jnp

    from hifihr_tpu.config import Config as JConfig
    from hifihr_tpu.losses.stack import LossComputer as JLossComputer
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
    from hifihr_tpu.training.steps import make_sched as jmake_sched
    from hifihr_tpu.training.steps import make_train_step as jmake_train_step
    from hifihr_tpu.training.train_state import TrainState as JTrainState
    from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from torch_port_helpers import jax_msaa_select_op_by_op, randomize_variables

    cfg = dict(CFG, rgb2hm=False, losses=LOSSES[:-1], init_lr=1e-5)
    batch = varied_batch(B, S)
    jax_faces = []
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces_msaa", lambda self, v, K: jax_msaa_select_op_by_op(self, v, K, jax_faces))
    try:
        jcfg = JConfig(**cfg)
        jm = JModel(config=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], b["Ks"], b["root_xyz"], train=False))(jb)
        v = randomize_variables(v, seed=0)
        del jax_faces[:]  # init's render
        mesh = make_mesh(2)
        assert mesh.devices.size == 2
        state = replicate(JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                                             batch_stats=v["batch_stats"]), mesh)
        step = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)
        sharded, sched = shard_batch(jb, mesh), jmake_sched(jcfg, 0)
        jax_losses = []
        for _ in range(2):
            state, d = step(state, sharded, sched)
            jax_losses.append({k: float(x) for k, x in d.items()})
    finally:
        mp.undo()
    assert len(jax_faces) == 2 and jax_faces[0][0].shape == (B, S, S)  # the whole batch's, each step
    runs = _spawn(dp_train_rank, 2, (cfg, batch, 1, 2, None, state_dict_from_flax(v), jax_faces), tmp_path)
    fired = tuple(k for k in FIRED if k != "hm_integral")
    for r in runs:
        assert len(r["own_faces"]) == 2
        for step_i, own in enumerate(r["own_faces"]):
            ref = jax_faces[step_i][0][r is runs[1] and slice(B // 2, B) or slice(0, B // 2)]
            assert (own.numpy() == ref).mean() >= (0.995, 0.95)[step_i]
        torch.testing.assert_close(r["flat"], runs[0]["flat"], rtol=0, atol=0)
        for step_i in range(2):
            got, want = r["losses"][step_i], jax_losses[step_i]
            assert set(got) == set(want) == set(fired) | {"skipped"}
            for k in fired:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {step_i + 1} {k}")


def _log_records(out_dir: str) -> list:
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_at_two_ranks(tmp_path):
    """configs/smoke_synthetic.json through the entry at 2 ranks (global
    batch 8): one epoch and its eval, written by rank 0 alone; its eval's
    metrics equal a one-rank evaluation of the checkpoint it saved."""
    with open(os.path.join(ROOT, "configs", "smoke_synthetic.json")) as f:
        raw = json.load(f)
    out2, out1 = str(tmp_path / "two"), str(tmp_path / "one")
    raw.update(base_out_path=out2, num_workers=0, print_freq=1)
    path2 = str(tmp_path / "two.json")
    with open(path2, "w") as f:
        json.dump(raw, f)
    _spawn(entry_rank, 2, (["--config_json", path2, "--device", "cpu"],), tmp_path)
    records = _log_records(out2)
    epochs = [r for r in records if "train_loss" in r]
    evals = [r["eval"] for r in records if "eval" in r]
    assert len(epochs) == 1 and len(evals) == 1  # one writer
    assert epochs[0]["skipped_steps"] == 0 and np.isfinite(epochs[0]["train_loss"])
    steps = [r for r in records if "step" in r and "epoch" in r and "loss" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]  # 32 samples / 8 a step, each logged once
    with open(os.path.join(out2, "train.log")) as f:
        assert f.read().count("best PA-MPJPE") == 1
    raw.update(base_out_path=out1, pretrain_model=os.path.join(out2, "model"))
    path1 = str(tmp_path / "one.json")
    with open(path1, "w") as f:
        json.dump(raw, f)
    from hifihr_tpu_torch.train import main

    one = main(["--config_json", path1, "--device", "cpu", "--mode", "evaluation"])
    two = evals[0]
    metrics = [k for k in one if isinstance(one[k], float)]
    assert {"pa_mpjpe_cm", "pa_mpvpe_cm", "pck_auc"} <= set(metrics)
    for k in metrics:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, err_msg=k)


def test_eval_at_n_ranks_bit_equal(tmp_path):
    """configs/smoke_synthetic.json with the render, test-time fitting and
    5 eval samples (batches of 2, 2 and a ragged 1; rank 0 takes the
    first and the last) evaluated from the same seeded weights at 2 ranks
    and at 1 (in this process, on one intra-op thread as each rank):
    PA metrics, the refined PA-MPJPE and the texture metrics (LPIPS at
    64 px too) equal to the bit, and rank 0 alone writes the eval record."""
    from hifihr_tpu_torch.train import main

    with open(os.path.join(ROOT, "configs", "smoke_synthetic.json")) as f:
        raw = json.load(f)
    paths = {}
    for world in (1, 2):
        raw.update(base_out_path=str(tmp_path / f"w{world}"), num_workers=0, render=True, controlled_size=5,
                   train_batch=2, val_batch=2, test_refinement=True)
        paths[world] = str(tmp_path / f"w{world}.json")
        with open(paths[world], "w") as f:
            json.dump(raw, f)
    argv = ["--device", "cpu", "--mode", "evaluation", "--config_json"]
    ranks = _spawn(entry_rank, 2, (argv + [paths[2]],), tmp_path)
    assert ranks[1] == ranks[0]  # every rank computes the metrics
    assert [r["eval"] for r in _log_records(str(tmp_path / "w2")) if "eval" in r] == [ranks[0]]  # one writer
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = main(argv + [paths[1]])
    finally:
        torch.set_num_threads(threads)
    keys = {k for k, v in one.items() if isinstance(v, float)}
    assert {"pa_mpjpe_cm", "pa_mpjpe_refined_cm", "tex_psnr", "tex_lpips_randinit"} <= keys
    assert ranks[0] == one
