"""The port's benchmark: RESCAL and TransR training on FB15k on one H100.

``python3 kgebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; ``BENCHMARK.json`` lists the
cells and metrics. Nothing here imports JAX or the JAX package.
"""

import importlib.util
from pathlib import Path


def load_module(path: Path):
    """A module of the benchmark from its file: the files of metrics, models
    and references are found by names that may hold dots, so they are
    loaded by path, not imported by name."""
    spec = importlib.util.spec_from_file_location(f"kgebench_{Path(path).stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
