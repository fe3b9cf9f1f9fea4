"""What a run finds by name: its cell in ``BENCHMARK.json``, the cell's
configuration file, traffic mix, limits and metric readers, and the code
that the mix names.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name that ``BENCHMARK.json`` or the mix
gives, so that a later cell or metric comes as new files and entries:

* ``configs``: each entry's ``file`` (``portbench/configs/<config>.json``);
* ``portbench/traffic/<traffic>.json``: the mix's parameters, read by the
  one generator in :mod:`pb.traffic`. The mix names the code it runs:
  ``rig`` (``portbench/rigs/<rig>.py``: how the window drives the
  program), ``arrivals`` (``portbench/arrivals/<law>.py``: a serve mix's
  arrival law) and ``sampler`` (``portbench/reference/samplers/<name>.py``:
  the reference's sampler of that name in the program);
* ``portbench/pending/<workload>.json``: the ``BENCHMARK.json`` entries of
  a cell kept out of the benchmark, which tools and tests can still run;
* ``portbench/limits/<workload>.json``: the limit of each number that
  decides ``correct`` (see :mod:`pb.compare`);
* ``portbench/metrics/<metric>.py``: a reader ``read(run) -> float | None``
  for each end-to-end and per-layer metric. A metric ``<base>.<tag>``
  without a file of its own is read by ``<base>.py``: the tag only splits
  one quantity among cells that report different end-to-end metrics.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    """A metric is the cell's where its ``workloads`` list the cell; a
    per-layer metric without the key, wherever the end-to-end metric it
    moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def with_pending(name: str, root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` with the entries of ``portbench/pending/<name>.json``
    added: a cell kept out of the benchmark, for the tools and tests that
    still drive it."""
    bench = load_json(root / "BENCHMARK.json")
    extra = load_json(root / BENCH_DIR.name / "pending" / f"{name}.json")
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + extra[key]
    return bench


def cell(name: str, root: Path = ROOT, pending: bool = False) -> Cell:
    """Cell ``name`` of ``BENCHMARK.json`` (``pending``: or of
    ``portbench/pending/<name>.json``)."""
    if pending and (root / BENCH_DIR.name / "pending" / f"{name}.json").is_file():
        bench = with_pending(name, root)
    else:
        bench = load_json(root / "BENCHMARK.json")
    try:
        wl = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, name, reported)]
    bench_dir = root / BENCH_DIR.name
    return Cell(
        name=name, workload=wl, config=load_json(root / conf["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{wl['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer, root=root,
    )


_LOADED: Dict[Path, object] = {}


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py`` (``kind`` may hold a
    ``/``), loaded once."""
    path = root / BENCH_DIR.name / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
        mod_name = "portbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<name>.py``, or of
    ``<base>.py`` for a metric ``<base>.<tag>`` without a file of its own."""
    if not (root / BENCH_DIR.name / "metrics" / f"{name}.py").is_file() and "." in name:
        name = name.split(".", 1)[0]
    return plugin("metrics", name, root).read
