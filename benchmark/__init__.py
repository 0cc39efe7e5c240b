"""The benchmark of the PyTorch and CUDA port (`hifihr_tpu_torch`) on one
H100: `python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON line.

Everything a cell is made of is found by name: its configuration in
configs/<config>.json, its traffic mix in traffic/<traffic>.json, each
per-layer metric's reader in metrics/<metric>.py and the cell's correctness
limits in limits/<cell>.json. A new cell, configuration, mix or metric is
new files and new entries in BENCHMARK.json, never an edit here.
"""
