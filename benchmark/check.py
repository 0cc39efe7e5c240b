"""What decides `correct`: the outputs of the timed path against the plain
reference (benchmark/reference/, or the package the configuration names
under "reference"), computed in the precision the
configuration states (the encoder under bf16 autocast where
`compute_dtype` says bfloat16, everything else in fp32 with TF32 off),
made from the same seeded weights and the same inputs, once the window has
closed and the program's state is freed.

The check compares the program's first three train steps, which set-up ran
through the window's own call: each loss term of the first step
(`term_gap`, the worst relative gap), each step's total loss (`loss_gap`,
the worst relative gap), each trained leaf's first gradient as the
optimizer got it (from Adam's first moment after one step, mu = (1 - b1) g;
`grad_gap`, the worst leaf) and each leaf's change over the three steps
(`update_gap_median`, the median leaf). Leaves are compared by norm: the
gap between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (they move by round-off alone under Adam). The change is
judged at the median leaf, not the worst: under the encoder's stated bf16
the worst leaf's change (an EfficientNet squeeze-excite reduction) reads
0.07-0.15 between two runs of the program itself on one seed, as much as
against the reference, and under 1e-3 when both run in fp32 (PERF.md §2).

The controls (CONTROLS) put the reference one precision step below the
stated one in the program's place: "fp8" runs the bf16 encoder's convs and
dense layers in fp8 (e4m3, one scale per tensor, weights and inputs),
"tf32" the fp32 rest in TF32, and "control" both.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import numpy as np
import torch
from torch import nn

from benchmark import spec
from benchmark.program import VGG_SEED_SALT
from benchmark.weights import load_seeded_weights

B1 = 0.9  # Adam's first-moment decay, the reference's and the port's
EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude to
    448), the gradient passed straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    q = ((x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)
    return x + (q - x).detach()


# the controls: each a step below the stated precision, in the encoder's
# bf16 part (fp8), in the fp32 rest (TF32), or in both ("control")
CONTROLS = ("control", "fp8", "tf32")


@contextlib.contextmanager
def numerics(model: nn.Module, precision: str):
    """TF32 off ("stated", "fp32"), or one of CONTROLS (see the module
    docstring)."""
    hooks = []
    if precision in ("control", "fp8"):
        with torch.no_grad():
            for m in model.encoder.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    m.weight.copy_(fp8_round(m.weight))
                    hooks.append(m.register_forward_pre_hook(lambda _m, args: (fp8_round(args[0]),) + args[1:]))
    tf32 = precision in ("control", "tf32")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def reference_fields(config_fields: dict, precision: str) -> dict:
    """The configuration as the reference runs it: as stated ("stated" and
    the CONTROLS, which go below it inside `numerics`), or all in fp32."""
    return dict(config_fields, compute_dtype="float32") if precision == "fp32" else dict(config_fields)


# ---------------------------------------------------------------- FLOPs


def _conv_macs(x_shape, w_shape, out_shape, transposed) -> int:
    """Multiply-adds of a convolution: each output element of a plain conv
    (each input element of a transposed one) takes prod(w_shape[1:]), which
    holds for grouped convs too (w_shape[1] is the channels per group)."""
    return math.prod(x_shape if transposed else out_shape) * math.prod(w_shape[1:])


def _conv_flop(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed, *args, out_shape=None,
               **kwargs) -> int:
    return 2 * _conv_macs(x_shape, w_shape, out_shape, transposed)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """The gradient of the input and of the weight each cost the forward's
    multiply-adds (torch's own formula ignores groups in both, which counts
    a depthwise conv's backward channels-fold)."""
    fwd = 2 * _conv_macs(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flop_counter():
    """torch's FlopCounterMode (matrix products and convolutions) with the
    convolution formulas above."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    return FlopCounterMode(display=False, custom_mapping={aten.convolution: _conv_flop,
                                                          aten.convolution_backward: _conv_backward_flop})


def encoder_flops(model: nn.Module, imgs: torch.Tensor) -> int:
    """The encoder's share of a train step's FLOPs, counted on the encoder
    alone on the step's images (forward, and the backward of both its
    outputs), since module attribution inside a backward is unreliable."""
    model.train()
    with flop_counter() as fc:
        low, feat = model.encoder(imgs.float() / 255.0 if imgs.dtype == torch.uint8 else imgs)
        (feat.float().sum() + (low.float().sum() if low is not None else 0.0)).backward()
    model.zero_grad(set_to_none=True)
    return fc.get_total_flops()


# ---------------------------------------------------------------- train


def reference_train(config_fields: dict, dataset: str, seed: int, device, pool: list,
                    precision: str = "stated", flops=None, reference: str = spec.DEFAULT_REFERENCE) -> dict:
    """The reference's first three steps from the seed's weights on pool
    batches 0..2: totals, the first gradient, the flat parameters before
    and after. `flops` (a FlopCounterMode) counts the first step.
    `reference` names the configuration's reference package (spec.py)."""
    ref = spec.reference_api(reference)
    cfg = ref.Config.from_dict(reference_fields(config_fields, precision))
    model = ref.build_model(cfg, device)
    load_seeded_weights(model, seed, device)
    lc = ref.LossComputer(cfg)
    if lc.vgg is not None:
        lc.vgg.to(device)
        load_seeded_weights(lc.vgg, seed + VGG_SEED_SALT, device)
    step = ref.make_train_step(model, lc, dataset, cfg)
    sched = ref.make_sched(cfg, 0, device)
    with numerics(model, precision):
        state = ref.create_train_state(model, cfg)
        opt = state.optimizer
        flat0 = opt.flat.clone()
        totals, g1, terms1 = [], None, None
        for i in range(3):
            with flops if (flops is not None and i == 0) else contextlib.nullcontext():
                _, losses = step(state, pool[i], sched)
            totals.append(losses["total"])
            if i == 0:
                g1 = opt.grad.clone()
                terms1 = loss_terms(losses)
    leaves, off = [], 0
    for p in opt.params:
        leaves.append((off, p.numel()))
        off += p.numel()
    out = {"flat0": flat0, "g1": g1, "flat3": opt.flat.clone(), "totals": torch.stack(totals).cpu(),
           "terms1": {k: float(v) for k, v in terms1.items()},
           "leaves": leaves, "names": [n for n, p in model.named_parameters() if p.requires_grad]}
    if flops is not None:
        out["encoder_flops"] = encoder_flops(model, pool[0]["imgs"])
    return out


def loss_terms(losses: dict) -> dict:
    """A step's loss terms, without its total and its skip flag."""
    return {k: v for k, v in losses.items() if k not in ("total", "skipped")}


def _norms(flat: torch.Tensor, leaves: list) -> np.ndarray:
    return np.array([torch.linalg.vector_norm(flat[o:o + n].double()).item() for o, n in leaves])


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    return np.abs(prog - ref) / np.maximum(ref, statistics.median(ref.tolist()))


def _sign_flips(a: torch.Tensor, b: torch.Tensor, leaves: list) -> np.ndarray:
    """Per leaf, the share of elements whose signs differ in a and b."""
    return np.array([(torch.sign(a[o:o + n]) != torch.sign(b[o:o + n])).double().mean().item() for o, n in leaves])


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog: loops.train_first_steps' record; ref: reference_train's. Keys
    with a leading `_` are for the record: `_by_leaf` holds each kept
    leaf's change gap, first-gradient gap, sign flips and size."""
    leaves = ref["leaves"]
    loss = float(((prog["totals"].double() - ref["totals"].double()).abs() / ref["totals"].double().abs()).max())
    # a term the program did not give reads as far off as can be
    terms = {k: abs(prog["terms1"].get(k, math.inf) - v) / max(abs(v), 1e-30) for k, v in ref["terms1"].items()}
    g1_prog = prog["mu1"] / (1.0 - B1)
    g_prog = _norms(g1_prog, leaves)
    g_ref = _norms(ref["g1"], leaves)
    keep = g_ref >= EXCLUDE_BELOW * statistics.median(g_ref.tolist())
    d_prog = _norms(prog["flat3"] - prog["flat0"], leaves)[keep]
    d_ref = _norms(ref["flat3"] - ref["flat0"], leaves)[keep]
    grad, update = _leaf_gaps(g_prog, g_ref), _leaf_gaps(d_prog, d_ref)
    flips = _sign_flips(g1_prog, ref["g1"], leaves)[keep]
    names = ref["names"]
    kept = [n for n, k in zip(names, keep) if k]
    worst_update = np.argsort(-update)[:4]
    out = {"loss_gap": loss, "term_gap": max(terms.values()), "grad_gap": float(grad.max()),
           "update_gap_median": float(np.median(update)),
           "_update_gap_worst": float(update.max()), "_median_grad_gap": float(np.median(grad)),
           "_median_sign_flips": float(np.median(flips)),
           "_leaves": len(leaves), "_left_out": [n for n, k in zip(names, keep) if not k],
           "_term_gaps": terms,
           "_worst_grad": [[names[i], float(grad[i])] for i in np.argsort(-grad)[:4]],
           "_worst_update": [[kept[i], float(update[i]), float(flips[i])] for i in worst_update]}
    numel = [n for (_, n), k in zip(leaves, keep) if k]
    out["_by_leaf"] = [[kept[i], float(update[i]), float(grad[keep][i]), float(flips[i]), numel[i]]
                       for i in range(len(kept))]
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}); a number
    that is not finite fails."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
