"""The port's tools and entry points against the JAX package's:
utils/visualize.py's `save_obj` (per-vertex colours, `vert_uv`, `face_uv`
with NIMBLE's 7-channel maps), `multiview_render` (the turntable, through
the renderer at 2 x 2 MSAA subsamples) and `save_2d_errors`;
compute_texture_metric.py; assets/convert_mano.py; and demo.py's `main` on
the CPU. Also utils/profiling.py: the spans (nesting, parents, step ids, a
stack per thread, the `.bwd` spans a train step's backward opens, nothing
recorded and no hook registered while they are off, the profiler's clock, a
train step bit-equal with them on), the route counters and `trace`.

The turntable: JAX's renderer takes its SSAA emulation of MSAA on the CPU,
so JAX's face choice is made by the Pallas MSAA kernel (interpret=True, op
by op), as tests/test_torch_modules.py::test_renderer_msaa_matches_jax
holds the renderer; frames within 1e-5 with equal silhouettes.
Tolerances elsewhere: the OBJ files byte-equal; the texture metrics within
1e-5 relative (PNG inputs decoded alike); the converted MANO arrays equal.
"""

import functools
import json
import os
import pickle
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from hifihr_tpu.utils import visualize as jvis
from hifihr_tpu_torch.utils import visualize
from torch_port_helpers import posed_mano_verts
from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)


def _mesh():
    from hifihr_tpu_torch.assets import load_mano_model

    m = load_mano_model()
    return posed_mano_verts(1, seed=3)[0], np.asarray(m.faces)


@pytest.mark.parametrize("mode", ["colors", "vert_uv", "face_uv"])
def test_save_obj_byte_equal(mode, tmp_path):
    rng = np.random.RandomState(0)
    verts, faces = _mesh()
    kwargs = {}
    if mode == "colors":
        kwargs["vert_colors"] = rng.rand(len(verts), 3).astype(np.float32)
    elif mode == "vert_uv":
        kwargs.update(vert_uv=rng.rand(len(verts), 2).astype(np.float32),
                      texture_image=rng.rand(16, 16, 3).astype(np.float32))
    else:  # a seamed atlas and NIMBLE's diffuse + normal + spec stack
        kwargs.update(face_uv=rng.rand(len(faces), 3, 2).astype(np.float32),
                      texture_image=rng.rand(16, 16, 7).astype(np.float32))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jvis.save_obj(str(tmp_path / "jax" / "hand.obj"), verts, faces, **kwargs)
    visualize.save_obj(str(tmp_path / "port" / "hand.obj"), verts, faces, **kwargs)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == {"colors": 1, "vert_uv": 3, "face_uv": 5}[mode]
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


def test_multiview_render_matches_jax(monkeypatch):
    """Two views (0 and 180 degrees) at 32 px, 2 x 2 subsamples, the faces
    in MANO's order."""
    from hifihr_tpu.render import raster_jax
    from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer

    def select(self, verts_cam, K_base):
        vs = raster_jax.project_to_screen(jax.lax.stop_gradient(verts_cam), K_base)
        fid, cov, _ = rasterize_msaa_pallas(vs, self.faces, self.settings.image_size,
                                            samples=self.settings.aa_factor, interpret=True)
        return fid, cov

    monkeypatch.setattr(JRenderer, "_select_faces_msaa", select)
    verts, faces = _mesh()
    colors = np.random.RandomState(1).rand(len(verts), 3).astype(np.float32)
    with jax.disable_jit():
        ref = jvis.multiview_render(verts, faces, colors, image_size=32, n_views=2)
    out = visualize.multiview_render(verts, faces, colors, image_size=32, n_views=2, device="cpu")
    assert out.shape == ref.shape == (2, 32, 32, 4)
    for k in range(2):
        assert 0.02 < (ref[k, ..., 3] > 0).mean() < 0.9, k
        np.testing.assert_array_equal(out[k, ..., 3] > 0, ref[k, ..., 3] > 0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_save_2d_errors(tmp_path):
    rng = np.random.RandomState(2)
    pred, gt = rng.rand(5, 21, 2) * 64, rng.rand(5, 21, 2) * 64
    ref = jvis.save_2d_errors(str(tmp_path / "jax" / "eval"), pred, gt)
    out = visualize.save_2d_errors(str(tmp_path / "port" / "eval"), pred, gt)
    np.testing.assert_array_equal(out, ref)
    assert (tmp_path / "jax" / "eval_2d_errors.txt").read_bytes() == (
        tmp_path / "port" / "eval_2d_errors.txt").read_bytes()
    assert (tmp_path / "port" / "eval_2d_errors.png").stat().st_size > 0


def _printed_means(capsys) -> dict:
    out = capsys.readouterr().out
    return {line.split(":")[0]: float(line.split()[1]) for line in out.splitlines() if "(n=" in line}


def test_compute_texture_metric(tmp_path, monkeypatch, capsys):
    """Three 64^2 PNG triples; both tools on the same LPIPS weights (JAX's
    random ones in the converted layout) print the same means."""
    import compute_texture_metric as jtool
    import hifihr_tpu.losses.lpips as jlpips
    import hifihr_tpu_torch.losses.lpips as tlpips
    from hifihr_tpu_torch import compute_texture_metric

    net = jlpips.LPIPS()
    z = {}
    for i in range(5):
        z[f"conv{i}_kernel"] = np.asarray(net.net_params["params"][f"conv{i}"]["kernel"])
        z[f"conv{i}_bias"] = np.asarray(net.net_params["params"][f"conv{i}"]["bias"])
        z[f"lin{i}_kernel"] = np.asarray(net.head_params["params"][f"lin{i}"]["kernel"])
    npz = str(tmp_path / "lpips_alex.npz")
    np.savez(npz, **z)
    monkeypatch.setattr(jlpips, "LPIPS_NPZ", npz)
    monkeypatch.setattr(tlpips, "LPIPS", functools.partial(tlpips.LPIPS, npz))
    rng = np.random.RandomState(3)
    d = tmp_path / "imgs"
    for i in range(3):
        sil = (rng.rand(64, 64, 1) > 0.4).astype(np.float32)
        visualize.write_png(str(d / f"{i}_raw_img.png"), rng.rand(64, 64, 3))
        visualize.write_png(str(d / f"{i}_re_img.png"), rng.rand(64, 64, 3) * sil)
        visualize.write_png(str(d / f"{i}_re_sil.png"), np.repeat(sil, 3, -1))
    monkeypatch.setattr(sys, "argv", ["compute_texture_metric.py", "--image_path", str(d)])
    jtool.main()
    ref = _printed_means(capsys)
    out = compute_texture_metric.main(["--image_path", str(d), "--device", "cpu"])
    assert _printed_means(capsys) == {k: float(f"{v:.5f}") for k, v in out.items()}
    assert set(out) == set(ref) == {"psnr", "ssim", "l1", "l2", "lpips"}
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_step_timer_and_trace(tmp_path):
    """trace() writes one Chrome trace that holds the program's spans, each
    on its thread's row and on the operators' clock: the SSIM's conv runs
    inside the `loss.ssim` span, its backward inside `loss.ssim.bwd`."""
    from hifihr_tpu_torch.losses.ssim import ssim
    from hifihr_tpu_torch.utils.profiling import trace

    img = torch.rand(2, 16, 16, 3, requires_grad=True)
    with trace(str(tmp_path)):
        ssim(img, torch.rand(2, 16, 16, 3)).backward()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert set(spans) == {"loss.ssim", "loss.ssim.bwd"}
    assert all(e["tid"] == threading.get_native_id() and e["pid"] == os.getpid() for e in spans.values())

    def inside(e, span):
        return span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"]

    convs = [e for e in events if e.get("ph") == "X" and e["name"] == "aten::conv2d"]
    conv_bwd = [e for e in events if e.get("ph") == "X" and e["name"] == "aten::convolution_backward"]
    assert len(convs) == 1 and inside(convs[0], spans["loss.ssim"])
    assert len(conv_bwd) == 1 and inside(conv_bwd[0], spans["loss.ssim.bwd"])


def test_spans_nest_carry_parent_and_step_and_keep_a_stack_per_thread():
    """Spans of one step share its id; a span opened on another thread (the
    autograd engine's, on the card) hangs under a continuation of the
    recording thread's innermost span and closes with it."""
    from hifihr_tpu_torch.utils import profiling

    workers = []

    def worker():
        workers.append(threading.get_native_id())
        profiling.span("loss.bwd").__enter__()  # left open: its thread never closes it

    with profiling.spans() as rec:
        for _ in range(2):
            with profiling.span("step", new_step=True):
                with profiling.span("encoder"):
                    pass
                with profiling.span("backward"):
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
                with profiling.span("optimizer"):
                    pass
        assert rec == []  # handed out when the block ends
    main = threading.get_native_id()

    def parent(s):
        return None if s.parent is None else rec[s.parent].name

    got = [(s.name, parent(s), s.step, s.thread == main) for s in rec]
    step = [("step", None, 0, True), ("encoder", "step", 0, True), ("backward", "step", 0, True),
            ("backward", "backward", 0, False), ("loss.bwd", "backward", 0, False), ("optimizer", "step", 0, True)]
    assert got == step + [(n, p, 1, m) for n, p, _, m in step]
    assert [rec[i].thread for i in (3, 4, 9, 10)] == [workers[0]] * 2 + [workers[1]] * 2
    for i in (2, 8):  # main's backward closes the worker's continuation and its open span
        assert rec[i].end_ns == rec[i + 1].end_ns == rec[i + 2].end_ns
    for s in rec:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_off_record_nothing_and_register_no_hook(monkeypatch):
    """Off, a site is the shared no-op: no span object is made, so no
    autograd hook is registered (only a span registers one) and none runs;
    on, the hooks open and close the `.bwd` span, and the values are the
    same bit for bit."""
    from hifihr_tpu_torch.losses.ssim import ssim
    from hifihr_tpu_torch.utils import profiling

    made, ran = [], []
    init, open_bwd, close_bwd = profiling._Span.__init__, profiling._Span._open_bwd, profiling._Span._close_bwd
    monkeypatch.setattr(profiling._Span, "__init__", lambda *a: made.append(a[2]) or init(*a))
    monkeypatch.setattr(profiling._Span, "_open_bwd", lambda sp, g: ran.append("open") or open_bwd(sp, g))
    monkeypatch.setattr(profiling._Span, "_close_bwd", lambda sp, g: ran.append("close") or close_bwd(sp, g))
    img, ref = torch.rand(2, 16, 16, 3, requires_grad=True), torch.rand(2, 16, 16, 3)
    assert profiling.span("a", img) is profiling.span("b")  # one shared no-op
    off = ssim(img, ref)
    off.backward()
    assert made == [] and ran == []
    grad_off, img.grad = img.grad, None
    with profiling.spans() as rec:
        on = ssim(img, ref)
        on.backward()
    assert made == ["loss.ssim"] and ran == ["open", "close"]
    assert [s.name for s in rec] == ["loss.ssim", "loss.ssim.bwd"] and rec[0].end_ns <= rec[1].start_ns
    assert torch.equal(on, off) and torch.equal(img.grad, grad_off)


def test_span_holds_its_ops_profiler_event_on_one_clock():
    from torch.profiler import ProfilerActivity, profile

    from hifihr_tpu_torch.utils import profiling

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.spans() as rec:
            with profiling.span("matmul"):
                x @ x
    (s,) = rec
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(ev) == 1
    assert s.start_ns <= ev[0].start_ns() and ev[0].start_ns() + ev[0].duration_ns() <= s.end_ns


def test_train_step_with_spans_on_is_bit_equal_and_splits_the_backward():
    """Two train steps with spans on: the same losses and parameters bit for
    bit as with them off, and each layer's backward in its `.bwd` span,
    in reverse forward order under `backward`."""
    import contextlib
    import warnings

    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state
    from hifihr_tpu_torch.utils import profiling
    from torch_port_helpers import fake_K

    b, size = 2, 32
    cfg = Config(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=size,
                 compute_dtype="float32", losses=("joint_3d", "joint_2d", "vert_3d", "mshape", "mpose", "sil",
                                                  "perceptual"))
    rng = np.random.RandomState(0)
    batch = {"imgs": torch.tensor(rng.rand(b, size, size, 3).astype(np.float32)),
             "Ks": torch.tensor(fake_K(b, size)), "root_xyz": torch.tensor([[[0.0, 0.0, 0.5]]]).repeat(b, 1, 1),
             "joints": torch.tensor((rng.randn(b, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32)),
             "j2d_gt": torch.tensor((rng.rand(b, 21, 2) * size).astype(np.float32)),
             "verts": torch.tensor((rng.randn(b, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32)),
             "segms_gt": torch.tensor((rng.rand(b, size, size) > 0.6).astype(np.float32)),
             "texture_con": torch.ones(b)}

    def run(spans_on):
        model = build_model(cfg, device="cpu", seed=0)
        state = create_train_state(model, cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the VGG19's DEGRADED warning
            step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
        sched = make_sched(cfg, 0, device="cpu")
        losses = []
        with profiling.spans() if spans_on else contextlib.nullcontext([]) as rec:
            for _ in range(2):
                losses.append(step(state, batch, sched)[1])
        return losses, state.optimizer.flat, rec

    off, flat_off, _ = run(False)
    on, flat_on, rec = run(True)
    assert torch.equal(flat_on, flat_off)
    for a, c in zip(off, on):
        assert a.keys() == c.keys() and all(torch.equal(a[k], c[k]) for k in a)

    def path(s):
        names = []
        while s.parent is not None:
            s = rec[s.parent]
            names.append(s.name)
        return "/".join(reversed(names))

    first = [(s.name, path(s)) for s in rec if s.step == 0]
    assert first == [
        ("step", ""), ("optimizer", "step"), ("encoder", "step"), ("hand", "step"), ("renderer", "step"),
        ("loss", "step"), ("loss.ssim", "step/loss"), ("loss.ssim", "step/loss"), ("loss.perceptual", "step/loss"),
        ("backward", "step"), ("loss.bwd", "step/backward"), ("loss.perceptual.bwd", "step/backward/loss.bwd"),
        ("loss.ssim.bwd", "step/backward/loss.bwd"), ("loss.ssim.bwd", "step/backward/loss.bwd"),
        ("renderer.bwd", "step/backward"), ("hand.bwd", "step/backward"), ("encoder.bwd", "step/backward"),
        ("optimizer", "step")]
    assert [(s.name, path(s)) for s in rec if s.step == 1] == first
    bwd = [s for s in rec if s.step == 0 and s.name.endswith(".bwd") and path(s) == "step/backward"]
    assert all(a.end_ns <= c.start_ns for a, c in zip(bwd, bwd[1:]))  # one after another


def test_route_counters_live_in_the_registry():
    """The routes' launch counts are profiling.counters' entries (the card
    counts them: chip_smoke.py's launches_per_route and
    check_route_launches); the CPU's plain versions count nothing."""
    from hifihr_tpu_torch.losses.ssim import ssim
    from hifihr_tpu_torch.render import gather, raster, raster_msaa
    from hifihr_tpu_torch.utils.profiling import counters

    assert set(counters) == {"rasterize_msaa.launches", "rasterize_msaa.device_launches",
                             "rasterize_face_id.launches", "rasterize_face_id.device_launches",
                             "gather_rows.launches", "scatter_rows.launches", "ssim.launches"}
    for fn in (raster_msaa.rasterize_msaa, raster.rasterize_face_id, gather.gather_rows, gather.scatter_rows):
        assert not hasattr(fn, "launches") and not hasattr(fn, "device_launches")
    before = dict(counters)
    gen = torch.Generator().manual_seed(0)
    screen = torch.rand(1, 30, 3, generator=gen) * torch.tensor([32.0, 32.0, 0.2]) + torch.tensor([0.0, 0.0, 0.4])
    faces = torch.randint(0, 30, (20, 3), generator=gen)
    raster_msaa.rasterize_msaa(screen, faces, 32)
    raster.rasterize_face_id(screen, faces, 32)
    table = torch.rand(1, 4, 3, requires_grad=True)
    gather.gather_rows(table, torch.tensor([[0, 3, -1]], dtype=torch.int32)).sum().backward()
    img = torch.rand(1, 12, 12, 3, generator=gen, requires_grad=True)
    ssim(img, torch.rand(1, 12, 12, 3, generator=gen)).backward()
    assert counters == before


def test_convert_mano(tmp_path, monkeypatch):
    """A MANO-schema pickle written here (chumpy.ch.Ch leaves, a chumpy
    select op for shapedirs, a scipy sparse J_regressor), converted by both
    packages, neither of which imports chumpy: the same arrays."""
    import types

    import scipy.sparse

    from hifihr_tpu.assets.convert_mano import convert as jconvert
    from hifihr_tpu_torch.assets import convert_mano

    ch = types.ModuleType("chumpy.ch")
    ch.Ch = type("Ch", (), {"__module__": "chumpy.ch"})
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", ch)

    def chumpy(**state):
        obj = ch.Ch()
        obj.__dict__.update(state)
        return obj

    rng = np.random.RandomState(4)
    kintree = np.stack([np.r_[2 ** 32 - 1, np.arange(15)], np.arange(16)]).astype(np.int64)
    dd = {
        "v_template": chumpy(x=rng.rand(778, 3)),
        "shapedirs": chumpy(a=chumpy(x=rng.rand(778 * 3 * 10 + 7)), idxs=rng.permutation(778 * 3 * 10),
                            preferred_shape=(778, 3, 10)),
        "posedirs": rng.rand(778, 3, 135),
        "J_regressor": scipy.sparse.csc_matrix(rng.rand(16, 778) * (rng.rand(16, 778) > 0.9)),
        "weights": chumpy(x=rng.rand(778, 16)),
        "hands_components": rng.rand(45, 45),
        "hands_mean": rng.rand(45),
        "f": rng.randint(0, 778, (1538, 3)).astype(np.uint32),
        "kintree_table": kintree,
    }
    pkl = tmp_path / "MANO_RIGHT.pkl"
    pkl.write_bytes(pickle.dumps(dd, protocol=2))
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    monkeypatch.delitem(sys.modules, "chumpy")
    ref = jconvert(str(pkl), str(tmp_path / "jax.npz"))
    out = convert_mano.convert(str(pkl), str(tmp_path / "port.npz"))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert out["shapedirs"].shape == (778, 3, 10) and out["parents"][0] == -1


def test_demo_main_on_cpu(tmp_path, monkeypatch):
    """demo.main on a PNG, a small config (res18, 64 px) and a checkpoint
    the port's CheckpointManager wrote: the OBJ's vertices are the restored
    model's mesh, the turntable holds 8 frames with a silhouette each, and
    the panel is drawn where matplotlib imports. The turntable renders at
    64^2 here: its plain face choice at the demo's 224^2 takes ~100 CPU
    seconds (chip_smoke.py's phase 33 runs it at 224^2 on the card)."""
    from hifihr_tpu_torch import demo
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.checkpoint import CheckpointManager
    from hifihr_tpu_torch.training.train_state import create_train_state

    cfg_path = tmp_path / "demo.json"
    cfg_path.write_text(json.dumps({"pretrain": "res18", "image_size": 64, "light_estimation": False,
                                    "compute_dtype": "float32"}))
    cfg = Config.from_json(str(cfg_path))
    model = build_model(cfg, device="cpu", seed=1)  # not the demo's seed 0: the restore must matter
    CheckpointManager(str(tmp_path / "model"), cfg.save_mode).save(create_train_state(model, cfg), 0)
    monkeypatch.setattr(visualize, "multiview_render", functools.partial(visualize.multiview_render, image_size=64))
    img = np.random.RandomState(5).rand(80, 96, 3)
    visualize.write_png(str(tmp_path / "in.png"), img)
    res = demo.main(["--image", str(tmp_path / "in.png"), "--config_json", str(cfg_path), "--checkpoint",
                     str(tmp_path / "model"), "--out", str(tmp_path / "out"), "--device", "cpu"])

    K, root = demo.demo_camera(64, "cpu")
    want = demo.forward(model, torch.as_tensor(demo.load_input(str(tmp_path / "in.png"), 64)[None]), K, root)
    np.testing.assert_array_equal(res["verts"], (want["mano_verts"][0] + root[0]).numpy())
    obj = (tmp_path / "out" / "hand.obj").read_text().splitlines()
    assert sum(line.startswith("v ") for line in obj) == 778 and sum(line.startswith("f ") for line in obj) == 1538
    assert res["frames"].shape == (8, 64, 64, 4)
    assert all((f[..., 3] > 0).any() for f in res["frames"])
    png = (tmp_path / "out" / "turntable.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and int.from_bytes(png[16:20], "big") == 8 * 64
    assert (tmp_path / "out" / "panel.png").stat().st_size > 0
