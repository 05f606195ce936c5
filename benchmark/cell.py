"""Everything a cell is made of, found by name.

A cell of ``BENCHMARK.json``'s ``workloads`` names a configuration and a
traffic mix; the harness finds, with no list of its own:

- the configuration: ``BENCHMARK.json``'s ``configs`` entry of that name,
  whose ``file`` holds the sizes;
- the mix: ``traffic/<traffic>.json``, the parameters of one kind of work;
- the kind's generator: ``kinds/<kind>.py``, named by the mix's ``kind``,
  whose ``Mix`` drives the program and whose ``FAULTS`` break its timed
  path;
- the limits of the numbers compared: ``limits/<cell>.json``;
- the per-layer metrics: each ``per_layer`` entry of ``BENCHMARK.json``
  that lists the cell (or lists no cells, and moves an end-to-end metric
  the cell reports) is read by ``metrics/<name>.py``'s ``read(ctx)``.

So a new configuration, mix, kind of work or metric is a new file and a
new entry, and no file is edited.
"""

import importlib.util
import json
import os
from dataclasses import dataclass, field

# the benchmark's folder, relative to the checkout's root
FOLDER = "benchmark"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list = field(default_factory=list)
    root: str = ""  # the checkout's root, where the kinds and the readers are


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; raises KeyError for
    an unknown cell."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, FOLDER)
    traffic = _load(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = _load(os.path.join(here, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name) and m["moves"] in names]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer, root=root)


def _module(root: str, folder: str, name: str):
    """``<root>/benchmark/<folder>/<name>.py``, loaded as a module."""
    path = os.path.join(root, FOLDER, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(root: str, kind_name: str):
    """``kinds/<kind_name>.py``: its ``Mix`` and its ``FAULTS``."""
    return _module(root, "kinds", kind_name)


def make_mix(cell: Cell, seed: int, device):
    """The cell's kind of work, ready for ``setup()``."""
    return kind(cell.root, cell.traffic["kind"]).Mix(cell.config, cell.traffic, seed, device)


def reader(root: str, metric_name: str):
    """``metrics/<metric_name>.py``'s ``read``."""
    return _module(root, "metrics", metric_name).read


@dataclass
class Context:
    """What a per-layer metric's reader reads: the traced slices, the
    unprofiled window's rate of steps or calls and the model FLOPs of one
    of them, and the cell's configuration and mix."""

    slice: object  # trace.Slice of the card's events and the runtime calls
    ops_slice: object  # trace.Slice with the host's ops and their shapes
    rate: float  # steps or calls per second over the unprofiled window
    unit_flops: float  # the model FLOPs of one step or call (costs.py)
    config: dict
    traffic: dict
