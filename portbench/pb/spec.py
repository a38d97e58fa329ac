"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix; the configuration's ``file`` holds its
deployment, ``portbench/traffic/<traffic>.json`` the mix,
``portbench/entries/<entry>.py`` the entry point a mix names, and
``portbench/metrics/<metric>.py`` each per-layer metric's reader.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic mix file
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list


def _reported(entries, cell: str, reported_e2e=None) -> list:
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported_e2e is None or m["moves"] in reported_e2e:
            out.append(m)
    return out


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(work))})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = _reported(bench["end_to_end"], name)
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(ROOT / cfg["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e,
                per_layer=_reported(bench["per_layer"], name,
                                    {m["name"] for m in e2e}))


def _module(folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        HERE / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader ``portbench/metrics/<name>.py``."""
    return _module("metrics", name)


def entry(name: str):
    """The entry module ``portbench/entries/<name>.py``."""
    return _module("entries", name)
