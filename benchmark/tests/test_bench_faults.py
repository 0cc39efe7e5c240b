"""The check fails what it must: each fault the cells can have, planted
under the timed path of a tiny run on the CPU (the look for a card
skipped), comes out `correct: false` against the cell's own limits; the
control reads above the sound program at a tiny size, and each control
(fp8 encoder, TF32 rest, both) fails the limits at the cell's own size on
the card."""

from __future__ import annotations

import time

import pytest
import torch

from bench_tiny import tiny_cell
from benchmark import calibrate, check, spec
from benchmark import run as bench_run

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def state_unchanged(program):
    """A step that returns its state as it was."""
    def step(state, batch, sched):
        one = torch.ones((), device=state.optimizer.flat.device)
        return state, {"total": one, "skipped": one * 0}

    program.step = step


def term_altered(program):
    """One loss term (and the total with it) raised by a thousandth where
    the step produces them; the update itself is left as it was."""
    step = program.step

    def faulty(state, batch, sched):
        state, losses = step(state, batch, sched)
        losses = dict(losses)
        k = next(k for k in losses if k not in ("total", "skipped"))
        losses["total"] = losses["total"] + 1e-3 * losses[k]
        losses[k] = losses[k] * 1.001
        return state, losses

    program.step = faulty


FAULTS = [(c, f) for c in CELLS for f in (state_unchanged, calibrate.half_batch, term_altered)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    cell.limits = spec.find_cell(name).limits
    out = bench_run.run_cell(cell, 2**31 + 99, 0.2, False, "cpu", t_start=time.perf_counter(),
                             patch_program=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_above_the_sound_program(name):
    cell = tiny_cell(name)
    numbers = calibrate.control_numbers(cell, 2**31 + 5, "cpu")
    sound = bench_run.run_cell(cell, 2**31 + 5, 0.2, False, "cpu", t_start=time.perf_counter())["_numbers"]
    assert any(numbers[k] > 10 * sound[k] + 1e-9 for k in cell.limits), (numbers, sound)


@pytest.mark.card
@pytest.mark.parametrize("precision", check.CONTROLS)
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1001, 2**31 + 1002, 2**31 + 1003])
def test_each_control_fails_the_limits_at_the_cells_size(card, name, seed, precision):
    cell = spec.find_cell(name)
    ok, checks = check.judge(calibrate.control_numbers(cell, seed, card, precision), cell.limits)
    assert not ok, checks
