"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix, and the metrics.  Each part is a file of
its own, found by its name:

* a configuration: the ``file`` that ``BENCHMARK.json`` gives it, a JSON
  object of the port's ``FiestaConfig`` fields beside ``source``,
  ``reduced``, ``assumed`` and ``reference`` (the plain reference's name);
* a plain reference: ``esdfbench/references/<reference>.py``;
* a traffic mix: ``esdfbench/traffic/<traffic>.json``;
* a per-layer metric: ``esdfbench/metrics/<name>.py``, whose ``read``
  takes a run's ``Reading`` and returns the number, or None where the run
  holds nothing to read.

So a later cell, mix, configuration or metric is a new file and a new
entry, and no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

#: keys of a configuration file that are not the program's fields
CONFIG_META = ("source", "reduced", "assumed", "reference", "deployment")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    fields: dict            # the program's configuration fields
    config_meta: dict       # source, reduced, assumed, reference
    traffic_name: str
    traffic: dict
    end_to_end: list        # BENCHMARK.json's metric entries of this cell
    per_layer: list
    root: Path

    @property
    def bench_dir(self) -> Path:
        return self.root / BENCH_DIR.name


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its parts."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    raw = load_json(root / configs[w["config"]]["file"])
    meta = {k: raw[k] for k in CONFIG_META if k in raw}
    fields = {k: v for k, v in raw.items() if k not in CONFIG_META}
    traffic = load_json(root / BENCH_DIR.name / "traffic"
                        / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        fields=fields, config_meta=meta, traffic_name=w["traffic"],
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(cell: Cell):
    """The plain reference module the cell's configuration names."""
    name = cell.config_meta["reference"]
    return load_module(cell.bench_dir / "references" / f"{name}.py",
                       f"esdfbench_reference_{name}")


def metric_reader(cell: Cell, metric: str):
    """The ``read`` function of per-layer metric ``metric``."""
    tag = metric.replace(".", "_").replace("-", "_")
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py",
                       f"esdfbench_metric_{tag}").read
