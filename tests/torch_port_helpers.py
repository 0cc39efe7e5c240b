"""Shared inputs for the parity tests of hifihr_tpu_torch against hifihr_tpu.

Inputs are made from numpy seeds and handed to both packages as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while a module that imports this
    fixture runs, then the count it had. The suite runs several workers at
    once, and torch's threads in each oversubscribe the host's cores:
    run side by side, the PR 13 files took 178 s with torch's default
    threads and 87 s with one (measured here on 8 cores)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fake_K(batch: int, size: int) -> np.ndarray:
    """The synthetic batch's intrinsics (__graft_entry__._fake_batch)."""
    f = size * 1.8
    K = np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    return np.tile(K[None], (batch, 1, 1))


def numpy_tree(tree) -> dict:
    return {k: numpy_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def randomize_variables(variables: dict, seed: int) -> dict:
    """Flax variables as numpy, as the flax init made them, with random
    BatchNorm running stats, MMPool mix and vertex albedo, so every
    converted tensor matters."""
    rng = np.random.RandomState(seed)
    v = numpy_tree(variables)

    def walk(tree):
        for k, x in tree.items():
            if hasattr(x, "items"):
                walk(x)
            elif k == "mean":
                tree[k] = (rng.randn(*x.shape) * 0.1).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    walk(v.get("batch_stats", {}))
    if "mmpool" in v["params"].get("encoder", {}):  # the ResNet encoders' pool
        v["params"]["encoder"]["mmpool"]["p"] = rng.randn(1).astype(np.float32)
    if "vert_tex" in v["params"]:
        v["params"]["vert_tex"] = (rng.randn(778, 3) * 0.3).astype(np.float32)
    return v


def seeded_variables(shapes: dict, seed: int) -> dict:
    """Flax variables of the shapes of `shapes` (jax.eval_shape of a model's
    init), drawn in numpy instead of by the model's init, whose jitted
    compile takes longer than the test around it: conv kernels
    lecun_normal-scaled (std sqrt(1 / fan_in)), dense kernels He-scaled,
    biases 0, BatchNorm scales 1, then `randomize_variables`."""
    rng = np.random.RandomState(seed)

    def draw(tree, name=""):
        out = {}
        for k, x in tree.items():
            if hasattr(x, "items"):
                out[k] = draw(x, k)
            elif k == "kernel":
                fan_in = int(np.prod(x.shape[:-1]))
                gain = 2.0 if len(x.shape) == 2 else 1.0
                out[k] = (rng.randn(*x.shape) * (gain / fan_in) ** 0.5).astype(np.float32)
            elif k == "scale" or k == "var":
                out[k] = np.ones(x.shape, np.float32)
            else:
                out[k] = np.zeros(x.shape, np.float32)
        return out

    return randomize_variables(draw(shapes), seed)


def jax_msaa_select_op_by_op(self, verts_cam, K_base, record=None):
    """Stands in for hifihr_tpu's PhongRenderer._select_faces_msaa: the
    Pallas MSAA kernel in interpret mode (the JAX CPU path otherwise emulates
    MSAA from an SSAA raster, which picks faces by another rule), run op by
    op in a host callback. Under jit, XLA contracts the projection's and the
    prep's multiply-adds and can move a face id on an edge-on subsample;
    op by op every operation rounds on its own, as in the port. Appends each
    call's (face_id, coverage) to `record` when one is given. The callback takes
    stop-gradient inputs, so it also runs inside jax.grad."""
    import jax
    import jax.numpy as jnp

    from hifihr_tpu.render import raster_jax
    from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas

    size, samples = self.settings.image_size, self.settings.aa_factor

    def host(verts, K, faces):
        with jax.disable_jit():
            vs = raster_jax.project_to_screen(jnp.asarray(verts), jnp.asarray(K))
            fid, cov, _ = rasterize_msaa_pallas(vs, jnp.asarray(faces), size, samples=samples,
                                                interpret=True)
        if record is not None:
            record.append((np.asarray(fid), np.asarray(cov)))
        return np.asarray(fid), np.asarray(cov)

    b = verts_cam.shape[0]
    out = (jax.ShapeDtypeStruct((b, size, size), jnp.int32),
           jax.ShapeDtypeStruct((b, size, size), jnp.float32))
    return jax.pure_callback(host, out, jax.lax.stop_gradient(verts_cam),
                             jax.lax.stop_gradient(K_base), self.faces)


def jax_ssaa_select_op_by_op(self, verts_cam, K_big, big, record=None):
    """Stands in for hifihr_tpu's PhongRenderer._select_faces (the SSAA face
    selection): raster_jax.rasterize_face_id run op by op under
    `jax.disable_jit()` in a host callback, so no face id hangs on XLA's
    multiply-add contraction (the interpreted Pallas kernel contracts too,
    and op by op it is too slow at 1538 faces). Appends each call's face ids
    to `record` when one is given. The callback takes stop-gradient inputs,
    so it also runs inside jax.grad."""
    import jax
    import jax.numpy as jnp

    from hifihr_tpu.render import raster_jax

    def host(verts, K, faces):
        with jax.disable_jit():
            vs = raster_jax.project_to_screen(jnp.asarray(verts), jnp.asarray(K))
            fid, zbuf = raster_jax.rasterize_face_id(vs, jnp.asarray(faces), big,
                                                     chunk=self.settings.face_chunk)
        if record is not None:
            record.append(np.asarray(fid))
        return np.asarray(fid), np.asarray(zbuf)

    b = verts_cam.shape[0]
    out = (jax.ShapeDtypeStruct((b, big, big), jnp.int32),
           jax.ShapeDtypeStruct((b, big, big), jnp.float32))
    return jax.pure_callback(host, out, jax.lax.stop_gradient(verts_cam),
                             jax.lax.stop_gradient(K_big), self.faces)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def posed_mano_verts(batch: int, seed: int, z: float = 0.5) -> np.ndarray:
    """Posed MANO meshes in camera space (JAX ManoLayer, small random pose
    and shape), root at z."""
    import jax.numpy as jnp

    from hifihr_tpu.hand.mano import ManoLayer

    rng = np.random.RandomState(seed)
    mano = ManoLayer(ncomps=45)
    pose = jnp.asarray(rng.randn(batch, 48) * 0.3, jnp.float32)
    beta = jnp.asarray(rng.randn(batch, 10) * 0.5, jnp.float32)
    return np.asarray(mano(pose, beta).verts) + np.asarray([0.0, 0.0, z], np.float32)


def nimble_params(batch: int, seed: int) -> dict:
    """Seeded non-trivial NIMBLE parameters as numpy: PCA pose (B, 30),
    shape (B, 20) and appearance (B, 10)."""
    rng = np.random.RandomState(seed)
    return {"pose_params": (rng.randn(batch, 30) * 0.5).astype(np.float32),
            "shape_params": (rng.randn(batch, 20) * 0.5).astype(np.float32),
            "texture_params": (rng.randn(batch, 10) * 0.5).astype(np.float32)}


def posed_nimble_verts(batch: int, seed: int, z: float = 0.5) -> np.ndarray:
    """Posed NIMBLE skins in camera space (JAX NimbleLayer on
    `nimble_params`), placed as the model places them: NIMBLE root (joint
    11) at (0, 0, z)."""
    import jax.numpy as jnp

    from hifihr_tpu.hand.nimble import NimbleLayer

    out = NimbleLayer()({k: jnp.asarray(v) for k, v in nimble_params(batch, seed).items()})
    verts = np.asarray(out["skin_verts"]) - np.asarray(out["nimble_joints"])[:, 11:12]
    return verts + np.asarray([0.0, 0.0, z], np.float32)


def jax_ssaa_select_recorded(self, verts_cam, K_big, big, record):
    """Stands in for hifihr_tpu's PhongRenderer._select_faces where the
    port shades JAX's face choice anyway: raster_jax.rasterize_face_id
    jitted (op by op it takes tens of seconds at NIMBLE's 11,926 faces) in a
    host callback that appends each call's (face_id, zbuf) to `record`."""
    import jax
    import jax.numpy as jnp

    from hifihr_tpu.render import raster_jax

    select = jax.jit(lambda vs, f: raster_jax.rasterize_face_id(vs, f, big, chunk=self.settings.face_chunk))

    def host(verts, K, faces):
        vs = raster_jax.project_to_screen(jnp.asarray(verts), jnp.asarray(K))
        fid, zbuf = (np.asarray(x) for x in select(vs, jnp.asarray(faces)))
        record.append((fid, zbuf))
        return fid, zbuf

    b = verts_cam.shape[0]
    out = (jax.ShapeDtypeStruct((b, big, big), jnp.int32),
           jax.ShapeDtypeStruct((b, big, big), jnp.float32))
    return jax.pure_callback(host, out, jax.lax.stop_gradient(verts_cam),
                             jax.lax.stop_gradient(K_big), self.faces)


def nimble_slice_batch(batch: int, size: int) -> dict:
    """The flagship batch's keys (__graft_entry__._fake_batch), with seeded
    targets and masks so that every term has a gradient (the NIMBLE slice
    tests' batch)."""
    rng = np.random.RandomState(0)
    return {
        "imgs": rng.rand(batch, size, size, 3).astype(np.float32),
        "Ks": fake_K(batch, size),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (batch, 1, 1)),
        "joints": (rng.randn(batch, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "j2d_gt": (rng.rand(batch, 21, 2) * size).astype(np.float32),
        "verts": (rng.randn(batch, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "segms_gt": (rng.rand(batch, size, size) > 0.6).astype(np.float32),
        "texture_con": rng.uniform(0.5, 1.0, batch).astype(np.float32),
        "scales": np.full((batch,), 0.0282, np.float32),
    }


def nimble_step_runs(cfg: dict, batch: dict, seeded_init: bool = False) -> tuple:
    """The eval step and two train steps of each package from the same
    converted weights on `batch`, in configuration `cfg` (a NIMBLE render,
    MSAA or SSAA); the weights are drawn by `seeded_variables` over the
    shapes of JAX's init where `seeded_init` is set, else by its jitted
    init and `randomize_variables`. JAX's face selection is recorded (MSAA: the Pallas kernel
    interpreted op by op; SSAA: raster_jax jitted) and the port shades JAX's
    choice, keeping its own; JAX's corner accumulation takes its fp32
    scatter-add fallback (its bf16 incidence matmul for NIMBLE's mesh is off
    by up to 1e-2). Returns (jax_run, port_run), each with the eval outputs,
    both steps' loss dicts (floats), the first step's gradients and the
    face choices (face ids) of the three renders."""
    from collections import namedtuple

    import jax
    import jax.numpy as jnp
    import pytest
    import torch

    import hifihr_tpu.render.mesh as jmesh
    from hifihr_tpu.config import Config as JConfig
    from hifihr_tpu.losses.stack import LossComputer as JLossComputer
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
    from hifihr_tpu.training.steps import make_eval_step as jmake_eval_step
    from hifihr_tpu.training.steps import make_sched as jmake_sched
    from hifihr_tpu.training.steps import make_train_step as jmake_train_step
    from hifihr_tpu.training.train_state import TrainState as JTrainState
    from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import HiFiHR
    from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    def floats(d):
        return {k: float(v) for k, v in d.items()}

    def no_incidence(*_):
        raise RuntimeError("the test takes JAX's fp32 corner accumulation")

    ssaa = cfg["aa_mode"] == "ssaa"
    jax_faces = []
    mp = pytest.MonkeyPatch()
    if ssaa:
        mp.setattr(JRenderer, "_select_faces",
                   lambda self, v, K, big: jax_ssaa_select_recorded(self, v, K, big, jax_faces))
    else:
        mp.setattr(JRenderer, "_select_faces_msaa",
                   lambda self, v, K: jax_msaa_select_op_by_op(self, v, K, record=jax_faces))
    mp.setattr(jmesh, "_corner_incidence", no_incidence)
    try:
        jcfg = JConfig(**cfg)
        jm = JModel(config=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        init = lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], b["Ks"], b["root_xyz"], train=False)  # noqa: E731
        if seeded_init:
            v = seeded_variables(jax.eval_shape(init, jb), 0)
        else:
            v = randomize_variables(jax.jit(init)(jb), seed=0)
        del jax_faces[:]  # init's render
        estate = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
        jeval = {k: np.asarray(x) for k, x in jmake_eval_step(jm, "FreiHand", jcfg)(estate, jb).items()}
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                                   batch_stats=v["batch_stats"])
        step = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)
        sched = jmake_sched(jcfg, 0)
        state, d1 = step(state, jb, sched)
        grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})
        state, d2 = step(state, jb, sched)
        jax_run = {"eval": jeval, "loss": [floats(d1), floats(d2)], "grads": grads,
                   "faces": [f for f, _ in jax_faces]}
    finally:
        mp.undo()
    assert len(jax_faces) == 3  # the eval step and two train steps

    model = HiFiHR(Config(**cfg))
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    own_faces = []
    r = model.renderer
    name = "select_faces_ssaa" if ssaa else "select_faces"
    select = getattr(r, name)

    def jax_choice(verts_cam, K):
        """The port's own choice, kept, and JAX's, returned."""
        own_faces.append(select(verts_cam, K)[0].numpy())
        a, b = jax_faces[len(own_faces) - 1]
        return torch.tensor(a), torch.tensor(b)

    setattr(r, name, jax_choice)
    tcfg = Config(**cfg)
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    teval = {k: x.numpy() for k, x in make_eval_step(model, "FreiHand", tcfg)(tb).items()}
    tstate = create_train_state(model, tcfg)
    tstep = make_train_step(model, LossComputer(tcfg), "FreiHand", tcfg)
    tsched = make_sched(tcfg, 0, device="cpu")
    tstate, d1 = tstep(tstate, tb, tsched)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    tstate, d2 = tstep(tstate, tb, tsched)
    port_run = {"eval": teval, "loss": [floats(d1), floats(d2)], "grads": grads, "faces": own_faces,
                "step": int(tstate.step)}
    return jax_run, port_run


def dp_train_rank(rank: int, world: int, device, cfg: dict, batch: dict, fsdp: int = 1, steps: int = 2,
                  ckpt_dir: str | None = None, state_dict: dict | None = None, faces: list | None = None) -> dict:
    """`steps` train steps of the port on this rank's rows of the global
    `batch` (numpy), from build_model's seeded init (or `state_dict`), over the mesh of the
    current process group (the one-rank mesh when there is none): a
    parallel.launch.spawn_ranks target. With `faces`, each step's MSAA face
    choice (face_id, coverage) of the whole batch, the step renders this
    rank's rows of that choice and returns its own under "own_faces".
    Returns every step's loss terms, the flat parameters (before and after),
    both moments whole and the step count; saves a checkpoint (epoch 0)
    into `ckpt_dir` when one is given. Imports no JAX."""
    import torch

    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.parallel.mesh import make_mesh, replicate
    from hifihr_tpu_torch.training.checkpoint import CheckpointManager
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    config = Config(**cfg)
    mesh = make_mesh(fsdp, device)
    model = build_model(config, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model = replicate(model, mesh)
    own = []
    if faces is not None:
        select = model.renderer.select_faces
        rows_of = mesh.rows(len(batch["imgs"]))

        def given(verts_cam, K):
            own.append(select(verts_cam, K)[0].cpu())
            fid, cov = faces[len(own) - 1]
            return torch.tensor(fid[rows_of], device=device), torch.tensor(cov[rows_of], device=device)

        model.renderer.select_faces = given
    state = create_train_state(model, config, mesh=mesh)
    step = make_train_step(model, LossComputer(config, mesh), "FreiHand", config)
    sched = make_sched(config, 0, device=device)
    rows = mesh.shard_batch({k: torch.tensor(v, device=device) for k, v in batch.items()})
    flat0 = state.optimizer.flat[:state.optimizer.n].cpu().clone()
    losses = []
    for _ in range(steps):
        state, d = step(state, rows, sched)
        losses.append({k: float(v) for k, v in d.items()})
    opt = state.optimizer
    mu, nu = opt.full_moments()
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir, "only_latest").save(state, 0)
    return {"losses": losses, "flat0": flat0, "flat": opt.flat[:opt.n].cpu().clone(), "mu": mu.cpu().clone(),
            "nu": nu.cpu().clone(), "step": int(state.step), "own_faces": own}


def varied_batch(batch: int, size: int, seed: int = 0) -> dict:
    """The slice tests' batch (test_torch_train_slice.py) with rows that
    differ in every key, openpose pseudo-labels and their confidences
    (`open_2dj`, `open_2dj_con`) included, so that no per-rank reduction
    that is wrong can cancel out between the ranks."""
    rng = np.random.RandomState(seed)
    root = np.stack([rng.uniform(-0.02, 0.02, batch), rng.uniform(-0.02, 0.02, batch),
                     rng.uniform(0.45, 0.6, batch)], -1)[:, None].astype(np.float32)
    K = fake_K(batch, size)
    K[:, :2, :2] *= rng.uniform(0.9, 1.1, (batch, 1, 1)).astype(np.float32)  # the focal length
    return {
        "imgs": rng.rand(batch, size, size, 3).astype(np.float32),
        "Ks": K,
        "root_xyz": root,
        "joints": (rng.randn(batch, 21, 3) * 0.03 + root).astype(np.float32),
        "j2d_gt": (rng.rand(batch, 21, 2) * size).astype(np.float32),
        "verts": (rng.randn(batch, 778, 3) * 0.03 + root).astype(np.float32),
        "segms_gt": (rng.rand(batch, size, size) > rng.uniform(0.3, 0.8, (batch, 1, 1))).astype(np.float32),
        "texture_con": rng.uniform(0.2, 1.0, batch).astype(np.float32),
        "open_2dj": (rng.rand(batch, 21, 2) * size).astype(np.float32),
        "open_2dj_con": rng.uniform(0.0, 1.0, (batch, 21, 1)).astype(np.float32),
        "scales": rng.uniform(0.025, 0.032, batch).astype(np.float32),
    }


def bn_rank(rank: int, world: int, device, x, g, momentum: float = 0.9) -> dict:
    """A flax-semantics BatchNorm2d (seeded scale and bias) in train mode on
    this rank's rows of `x` over the current process group, with `g` (this
    rank's rows of the output's gradient) backpropagated: the output, the
    running statistics, the input's gradient and the scale's and bias's
    gradients summed over the ranks. A parallel.launch.spawn_ranks target;
    at one rank without a process group, the native path."""
    import torch
    import torch.distributed as dist

    from hifihr_tpu_torch.networks.batchnorm import BatchNorm2d
    from hifihr_tpu_torch.parallel.mesh import make_mesh, replicate

    mesh = make_mesh(1, device)
    bn = BatchNorm2d(x.shape[1], momentum=momentum)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        bn.weight.copy_(torch.rand(x.shape[1], generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(x.shape[1], generator=gen))
    bn = replicate(bn.to(device), mesh).train()
    rows = mesh.rows(x.shape[0])
    xr = x[rows].clone().to(device).requires_grad_()
    out = bn(xr)
    out.backward(g[rows].to(device))
    pg = torch.cat([bn.weight.grad, bn.bias.grad])
    if mesh.distributed:
        dist.all_reduce(pg, group=mesh.group)
    return {"out": out.detach().cpu(), "grad_x": xr.grad.cpu(), "grad_params": pg.cpu(),
            "running_mean": bn.running_mean.cpu(), "running_var": bn.running_var.cpu()}


def entry_rank(rank: int, world: int, device, argv: list):
    """`python -m hifihr_tpu_torch.train` with `argv` in this rank, in the
    process group the launcher started: a parallel.launch.spawn_ranks
    target. Returns what main returns. Imports no JAX."""
    from hifihr_tpu_torch.train import main

    del rank, world, device
    return main(argv)


def dp_suite_rank(rank: int, world: int, device, cfg: dict, batch: dict, ckpt_dir: str,
                  nan_batch: dict | None = None) -> dict:
    """dp_train_rank three times in one process group: two steps at fsdp 1
    ("dp"), two at fsdp 2 saving a checkpoint into `ckpt_dir` ("fsdp"),
    and, with `nan_batch`, one on that batch ("skip"); one spawn for all."""
    out = {"dp": dp_train_rank(rank, world, device, cfg, batch),
           "fsdp": dp_train_rank(rank, world, device, cfg, batch, fsdp=2, ckpt_dir=ckpt_dir)}
    if nan_batch is not None:
        out["skip"] = dp_train_rank(rank, world, device, cfg, nan_batch, steps=1)
    return out
