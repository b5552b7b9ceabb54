"""The benchmark of the PyTorch/CUDA port (`deeplearning4j_tpu_torch`).

One run of one cell: `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`. Everything a cell needs is found by name:
its configuration in `configs/`, its traffic mix in `traffic/` (which names
a driver in `drivers/`), its correctness limits in `limits/`, each
per-layer metric's reader in `metrics/`, and the kernel families of the
rooflines in `families/` with their work in `counts/`. The plain
references the outputs are judged by live in `reference/`; `models/`
holds the thin adapters that build the port's networks from a
configuration and hand them the benchmark's weights.
"""
