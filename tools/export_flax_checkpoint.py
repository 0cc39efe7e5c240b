"""Export a JAX package checkpoint (an orbax `texturehand_<tag>` directory
that hifihr_tpu/training/checkpoint.py writes) to one npz that the PyTorch
port reads without JAX (hifihr_tpu_torch/training/checkpoint.py::
load_flax_export):

    python tools/export_flax_checkpoint.py <model dir> <out.npz> [--tag latest]

Keys, each a '/'-joined flax path:
  params/<path>, batch_stats/<path>   the model's variables
  mu/<path>, nu/<path>                Adam's moments of the trained
                                      parameters (under optax.multi_transform,
                                      when modules are frozen, the trained
                                      group's; frozen parameters have none)
  count                               Adam's update count
  epoch                               the epoch the checkpoint was saved at
It imports orbax, so it runs where the JAX package runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _flat(tree, prefix: str, out: dict) -> None:
    """Every non-None leaf of a nested dict under '/'-joined keys."""
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flat(v, path, out)
        elif v is not None:
            out[path] = np.asarray(v)


def _adam_state(tree):
    """The first {count, mu, nu} dict in the restored opt_state: optax's
    ScaleByAdamState, at the top of a plain chain or inside
    multi_transform's 'trained' group."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def export(model_dir: str, out_npz: str, tag: str = "latest") -> dict:
    import orbax.checkpoint as ocp

    stored = ocp.PyTreeCheckpointer().restore(os.path.join(os.path.abspath(model_dir), f"texturehand_{tag}"))
    out: dict = {}
    _flat(stored["params"], "params", out)
    _flat(stored.get("batch_stats") or {}, "batch_stats", out)
    adam = _adam_state(stored["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the checkpoint's opt_state")
    _flat(adam["mu"], "mu", out)
    _flat(adam["nu"], "nu", out)
    out["count"] = np.asarray(adam["count"], np.int64)
    out["epoch"] = np.asarray(stored.get("epoch", 0), np.int64)
    np.savez(out_npz, **out)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_dir")
    ap.add_argument("out_npz")
    ap.add_argument("--tag", default="latest")
    args = ap.parse_args(argv)
    out = export(args.model_dir, args.out_npz, args.tag)
    print(f"wrote {args.out_npz}: {sum(k.startswith('params/') for k in out)} parameters, "
          f"{sum(k.startswith('mu/') for k in out)} trained, count {int(out['count'])}, epoch {int(out['epoch'])}")


if __name__ == "__main__":
    main()
