"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s, from process start): the cell's inputs from the
seed on the card, the port's step built through its entry points with the
benchmark's seeded weights, and every shape the window uses run once (the
program's first train steps, which the check compares). Then the window: the
traffic's loop for `--seconds`; with `--trace 1` traced by torch.profiler
with the port's layer spans on and its kernel calls recorded
(tracing.py). Then the check: the program's state freed, the plain
reference of the configuration (its "reference" package) from the same
seed and inputs, each compared number beside its limit. `--trace 0` reports
the cell's end-to-end metrics, `--trace 1` its per-layer ones.

Exits 2 without a result where the card or the cell's card count is
missing, and 3 where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import check, loops, spec  # noqa: E402
from benchmark.scene import posed_hands, split_batches  # noqa: E402

# top-level module names that no run may load: JAX, its libraries and the
# JAX package (compared whole: hifihr_tpu_torch is the port and passes)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "chex", "hifihr_tpu"})


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def make_pool(cell: spec.Cell, seed: int, device) -> list:
    """The traffic's pool of distinct batches, from the seed, on `device`."""
    batch = spec.batch_size(cell)
    size = int(spec.port_config_dict(cell.config).get("image_size", 224))
    gen = torch.Generator(device=device).manual_seed(seed)
    hands = posed_hands(cell.traffic["pool_batches"] * batch, size, cell.traffic["scene"], gen, device)
    return split_batches(hands, batch, tuple(cell.config["batch_keys"]))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, patch_program=None) -> dict:
    """One run of `cell`: the result's fields, before printing.
    `patch_program(program)` may replace the program's step (the tests'
    planted faults)."""
    from benchmark.program import build_program

    loop = cell.traffic["loop"]
    if loop not in loops.LOOPS:
        raise ValueError(f"{cell.name}: traffic loop {loop!r} is not one of {sorted(loops.LOOPS)}")
    first_steps, run_window = loops.LOOPS[loop]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dataset = cell.config.get("dataset", "FreiHand")
    fields = spec.port_config_dict(cell.config)
    batch = spec.batch_size(cell)

    pool = make_pool(cell, seed, device)
    program = build_program(fields, dataset, seed, device)
    if patch_program is not None:
        patch_program(program)
    first = first_steps(program, pool)
    sync()
    setup_s = time.perf_counter() - t_start

    calls = summary = spans = counters = None
    gc_pauses = []
    host = host_clock()
    gc.callbacks.append(lambda phase, info: gc_pauses.append(time.perf_counter()))
    if trace:
        from benchmark import tracing

        # the calls of the kernels whose roofline the cell reports, and no others
        with tracing.kernel_calls(tracing.roofline_kernels(cell.per_layer), cell.here) as calls:
            result, summary, spans, counters = tracing.profile_window(lambda: run_window(program, pool, seconds))
    else:
        result = run_window(program, pool, seconds)
    gc.callbacks.pop()
    host = {k: v - host[k] for k, v in host_clock().items()}
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program's first steps kept for the check; its state freed
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    flops = check.flop_counter() if trace else None
    ref = check.reference_train(fields, dataset, seed, device, pool, flops=flops, reference=cell.reference)
    numbers = check.train_numbers(first, ref)
    correct, checks = check.judge(numbers, cell.limits)

    run = dict(result, setup_s=setup_s, batch=batch, trace=summary, calls=calls, spans=spans, counters=counters,
               here=cell.here)
    if flops is not None:
        # the encoder's FLOPs run in bf16 where the configuration says so
        enc = ref["encoder_flops"] if fields.get("compute_dtype", "bfloat16") == "bfloat16" else 0
        total = flops.get_total_flops()
        run["flops"] = {"bf16_per_image": enc / batch, "fp32_per_image": (total - enc) / batch}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], cell.here)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": cell.chips,
           "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        from benchmark import tracing

        busy, _, _ = tracing.busy_and_gaps(summary)
        dev["busy_s"] = busy
        dev["window_s"] = result["window_s"]
        got = tracing.attribution(run)
        out["breakdown"] = tracing.breakdown(summary, spans, got[0] if got else None)
    out["checks"] = checks
    # the host's side of the window, for the record on standard error
    gc_s = sum(b - a for a, b in zip(gc_pauses[0::2], gc_pauses[1::2]))
    out["_numbers"] = dict(numbers, _host=dict(host, gc_s=gc_s, gc_n=len(gc_pauses) // 2,
                                               loadavg=os.getloadavg()[0]))
    if trace:
        out["_numbers"]["_trace"] = trace_record(run)
    return out


def trace_record(run: dict) -> dict:
    """The traced window's reduction, for the record on standard error:
    busy ms a step, and with spans tracing.span_summary's (each layer's and
    each span name's device ms, the share of busy they cover, the
    operations no span holds); the port's counters' change."""
    from benchmark import tracing

    busy, _, _ = tracing.busy_and_gaps(run["trace"])
    rec = {"busy_ms_per_step": busy * 1e3 / max(run["steps"], 1), "reduce_s": run["trace"]["reduce_s"],
           "spans": len(run["spans"]), "counters": run["counters"]}
    got = tracing.attribution(run)
    if got is not None:
        rec |= tracing.span_summary(run["trace"], run["spans"], *got, run["here"])
    return rec


def host_clock() -> dict:
    """The process's CPU seconds and involuntary context switches, the
    machine's steal seconds (what its hypervisor gave to others, all cores)
    and the wall clock, to tell a window the host starved from one it ran."""
    steal = 0.0
    with contextlib.suppress(OSError, ValueError, IndexError), open("/proc/stat") as f:
        steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    return {"cpu_s": time.process_time(), "wall_s": time.perf_counter(), "steal_s": steal,
            "nivcsw": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths (the
    # port's kernels build into build/hifihr_tpu_torch by themselves)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    # one host thread for torch's own CPU work: the card's work is
    # dispatched from this thread alone, and the host's cores are shared
    torch.set_num_threads(1)
    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the port and the benchmark must not import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    numbers = out.pop("_numbers")
    record = {k: v for k, v in numbers.items() if k.startswith("_") and k != "_by_leaf"}
    print(json.dumps(record | {"power_limit": power_limit()}),
          file=sys.stderr)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


def power_limit() -> str | None:
    """The card's name and power limit from nvidia-smi, or None."""
    import subprocess

    with contextlib.suppress(OSError, subprocess.SubprocessError):
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    return None


if __name__ == "__main__":
    sys.exit(main())
