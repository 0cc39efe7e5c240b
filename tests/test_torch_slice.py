"""The ported slice end to end: `make_eval_step` of both packages on the same
converted weights and inputs, in the verify skill's small configuration
(res18, 32 px, 3x3 MSAA, no light estimation, fp32, batch 2); and the port's
import hygiene.

The JAX side selects faces with the Pallas MSAA kernel in interpret mode
(its CPU path otherwise emulates MSAA from an SSAA raster, which picks faces
by another rule) and runs op by op under `jax.disable_jit()`, so XLA does not
contract the rasteriser's multiply-adds. Tolerances: joints, mano_verts and
j2d 1e-4 (j2d is in pixels at f = 57.6); re_sil exactly equal; re_img and
re_depth 1e-4. The two packages' vertices differ in their last bits (fp32
sums in another order), which can move a subsample that lies on a face edge
across it. So the render is held two ways: the port's renderer on JAX's own
vertices picks JAX's faces at every pixel and agrees within 1e-4 everywhere;
end to end, both pick the same face at 99.9% of pixels or more, and those
pixels agree within 1e-4.
"""

import os
import subprocess
import sys
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.render import raster_jax
from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas
from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
from hifihr_tpu.training.steps import make_eval_step as jax_make_eval_step
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.render.shading import DirectionalLight
from hifihr_tpu_torch.training.steps import make_eval_step
from torch_port_helpers import fake_K, randomize_variables

B, S = 2, 32
SMALL = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False,
             image_size=S, aa_factor=3, aa_mode="msaa", compute_dtype="float32")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_rule(selected: list):
    def select(self, verts_cam, K_base):
        vs = raster_jax.project_to_screen(jax.lax.stop_gradient(verts_cam), K_base)
        fid, cov, _ = rasterize_msaa_pallas(vs, self.faces, self.settings.image_size,
                                            samples=self.settings.aa_factor, interpret=True)
        selected.append(np.asarray(fid))
        return fid, cov

    return select


@pytest.fixture(scope="module")
def both_outputs():
    """(JAX outputs, port outputs, faces and render detail)."""
    jax_fid = []
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces_msaa", _kernel_rule(jax_fid))
    try:
        rng = np.random.RandomState(0)
        imgs = (rng.rand(B, S, S, 3) * 255).astype(np.uint8)
        K = fake_K(B, S)
        root = np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (B, 1, 1))
        jm = JModel(config=JConfig(**SMALL))
        v = jm.init(jax.random.PRNGKey(0), jnp.zeros((B, S, S, 3)), jnp.asarray(K),
                    jnp.asarray(root), train=False)
        v = randomize_variables(v, seed=0)
        state = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
        batch = {"imgs": imgs, "Ks": K, "root_xyz": root}
        with jax.disable_jit():
            ref = jax_make_eval_step(jm, "FreiHand", JConfig(**SMALL))(
                state, {k: jnp.asarray(x) for k, x in batch.items()})
        ref = {k: np.asarray(x) for k, x in ref.items()}
    finally:
        mp.undo()

    model = HiFiHR(Config(**SMALL))
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    step = make_eval_step(model, "FreiHand", Config(**SMALL))
    out = step({k: torch.tensor(x) for k, x in batch.items()})
    out = {k: x.numpy() for k, x in out.items()}

    # the port's face choice end to end, and its renderer on JAX's vertices
    Kt = torch.tensor(K)
    with torch.no_grad():
        port_fid = model.renderer.select_faces(torch.tensor(out["mano_verts"] + root), Kt)[0]
        jax_verts = torch.tensor(ref["mano_verts"] + root)
        on_jax_fid = model.renderer.select_faces(jax_verts, Kt)[0]
        rgba = model.renderer(jax_verts, model._vertex_albedo(B), Kt, DirectionalLight.default(B))
    # jax_fid[-1] is the eval step's face choice (init made the first)
    detail = {"jax_fid": jax_fid[-1], "port_fid": port_fid.numpy(), "on_jax_fid": on_jax_fid.numpy(),
              "on_jax": {"re_img": rgba[..., :3].numpy(), "re_depth": rgba[..., 4].numpy()}}
    return ref, out, detail


def test_eval_step_keys_and_shapes(both_outputs):
    ref, out, _ = both_outputs
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        assert np.all(np.isfinite(out[k])), k
    assert out["re_sil"].shape == (B, S, S, 1) and out["re_img"].shape == (B, S, S, 3)
    assert set(np.unique(out["re_sil"])) == {0.0, 255.0}
    np.testing.assert_allclose(out["joints"][:, 9], 0.0, atol=1e-6)  # root-centred


@pytest.mark.parametrize("key", ["joints", "mano_verts", "j2d"])
def test_eval_step_geometry(both_outputs, key):
    ref, out, _ = both_outputs
    np.testing.assert_allclose(out[key], ref[key], atol=1e-4)


def test_eval_step_silhouette_exact(both_outputs):
    ref, out, _ = both_outputs
    assert 0.05 < (ref["re_sil"] > 0).mean() < 0.95
    np.testing.assert_array_equal(out["re_sil"], ref["re_sil"])


@pytest.mark.parametrize("key", ["re_img", "re_depth"])
def test_eval_step_render(both_outputs, key):
    ref, out, d = both_outputs
    assert np.abs(ref[key]).max() > 0.1
    np.testing.assert_array_equal(d["on_jax_fid"], d["jax_fid"])
    np.testing.assert_allclose(d["on_jax"][key], ref[key], atol=1e-4)
    same = d["port_fid"] == d["jax_fid"]
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(out[key][same], ref[key][same], atol=1e-4)


@pytest.mark.parametrize("key", ["pose_params", "shape_params", "trans", "scale"])
def test_eval_step_hand_params(both_outputs, key):
    ref, out, _ = both_outputs
    np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4)


def test_port_imports_no_jax():
    """Importing the port, every one of its modules and chip_smoke.py loads
    neither JAX, flax nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import hifihr_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'hifihr_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods + ['chip_smoke']]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'hifihr_tpu'))\n"
        "assert not bad, bad\n"
        "new = {'hifihr_tpu_torch.losses.basic', 'hifihr_tpu_torch.losses.ssim',\n"
        "       'hifihr_tpu_torch.losses.stack', 'hifihr_tpu_torch.training.train_state',\n"
        "       'hifihr_tpu_torch.networks.batchnorm'}\n"
        "assert new <= set(mods) and len(mods) >= 25, mods\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
