"""The readings the correctness limits are set from, for one cell, in one
process on the card (set-up is long, so one process reads every seed):

    python3 benchmark/calibrate.py --workload <cell> --seeds 101,102,... \\
        --control 3 --fault 3 --look 3 --seconds 2 [--out chiprun_out/calibrate.json]

- sound runs: the whole run (set-up, a short window at the cell's load, the
  check) on each seed, each compared number read with no limit;
- the controls: the reference one precision step down (check.CONTROLS: the
  bf16 encoder in fp8, the fp32 rest in TF32, and both) against the
  reference as stated, on the first `--control` seeds, at the cell's sizes
  and inputs;
- the planted fault, half of each batch left out (the mean over
  the rest), through the whole run on the first `--fault` seeds. A step
  that returns its state unchanged reads about 1 on update_gap_median and
  needs no run;
- the look: on the first `--look` seeds, whole runs with the program and
  the reference both in fp32 throughout, to tell the noise of the
  encoder's bf16 from a departure of the program; and on the same seeds
  the program's first steps run twice as stated, the second run put in the
  reference's place, to read the program's own run-to-run noise.

It prints one JSON line per reading and, last, the largest sound reading
and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import check, spec  # noqa: E402
from benchmark.run import make_pool, run_cell  # noqa: E402


def half_batch(program) -> None:
    """The planted fault: every step sees the first half of its batch."""
    step = program.step

    def faulty(state, batch, sched):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, sched)

    program.step = faulty


def control_numbers(cell: spec.Cell, seed: int, device, precision: str = "control") -> dict:
    """The numbers of `precision` (one of check.CONTROLS) put in the
    program's place."""
    fields = spec.port_config_dict(cell.config)
    dataset = cell.config.get("dataset", "FreiHand")
    pool = make_pool(cell, seed, device)
    ref = check.reference_train(fields, dataset, seed, device, pool, reference=cell.reference)
    ctl = check.reference_train(fields, dataset, seed, device, pool, precision=precision, reference=cell.reference)
    return check.train_numbers(dict(ctl, mu1=ctl["g1"] * (1.0 - check.B1)), ref)


def program_first_steps(cell: spec.Cell, seed: int, device) -> dict:
    """The program's first steps on `seed` (as a train run's set-up makes
    them), in the form check.reference_train gives."""
    from benchmark import loops
    from benchmark.program import build_program

    fields = spec.port_config_dict(cell.config)
    program = build_program(fields, cell.config.get("dataset", "FreiHand"), seed, device)
    first = loops.train_first_steps(program, make_pool(cell, seed, device))
    leaves, off = [], 0
    for p in program.state.optimizer.params:
        leaves.append((off, p.numel()))
        off += p.numel()
    names = [n for n, p in program.model.named_parameters() if p.requires_grad]
    return dict(first, g1=first["mu1"] / (1.0 - check.B1), leaves=leaves, names=names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    ap.add_argument("--look", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = spec.find_cell(args.workload)
    cell.limits = {}
    rows = []

    def emit(kind, seed, numbers, extra=None):
        row = {"cell": cell.name, "kind": kind, "seed": seed, **numbers, **(extra or {})}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "_by_leaf"}), flush=True)

    for seed in seeds:
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda", t_start=t0)
        emit("sound", seed, out["_numbers"], {"failed": out["failed"], "attempted": out["attempted"],
                                               "metrics": out["metrics"], "s": time.perf_counter() - t0})
    for seed in seeds[:args.control]:
        for precision in check.CONTROLS:
            t0 = time.perf_counter()
            emit(precision, seed, control_numbers(cell, seed, "cuda", precision), {"s": time.perf_counter() - t0})
    for seed in seeds[:args.fault]:
        out = run_cell(cell, seed, args.seconds, False, "cuda", t_start=time.perf_counter(),
                       patch_program=half_batch)
        emit("half_batch", seed, out["_numbers"])
    if args.look:
        fp32 = copy.deepcopy(cell)
        fp32.config["compute_dtype"] = "float32"
        for seed in seeds[:args.look]:
            emit("fp32_both", seed, run_cell(fp32, seed, args.seconds, False, "cuda",
                                             t_start=time.perf_counter())["_numbers"])
        for seed in seeds[:args.look]:
            again = program_first_steps(cell, seed, "cuda")
            emit("program_twice", seed, check.train_numbers(program_first_steps(cell, seed, "cuda"), again))
    names = [k for k in rows[0] if k not in ("cell", "kind", "seed") and not k.startswith("_")
             and isinstance(rows[0][k], float)]
    summary = {"cell": cell.name, "kind": "summary"}
    for k in names:
        summary[k] = {"sound_max": max(r[k] for r in rows if r["kind"] == "sound")}
        for kind in check.CONTROLS + ("half_batch", "fp32_both", "program_twice"):
            vals = [r[k] for r in rows if r["kind"] == kind and k in r]
            if vals:
                summary[k][f"{kind}_min"] = min(vals)
                summary[k][f"{kind}_all"] = vals
        summary[k]["sound_all"] = [r[k] for r in rows if r["kind"] == "sound"]
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows + [summary], f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
