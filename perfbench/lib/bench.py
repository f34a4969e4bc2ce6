"""The benchmark's definition, read from ``BENCHMARK.json`` at the root of
the checkout, and the files it names, all found by name: each
configuration's file and its scene generator (``scenes/<generator>.py``),
each traffic mix's parameters (``traffic/<mix>.json``) and the closed
loop it names (``loops/<loop>.py``), each cell's limits of correctness
(``limits/<cell>.json``), and each metric's reader: ``e2e/<metric>.py``
for an end-to-end metric, ``metrics/<metric>.py`` for a per-layer one."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics resolved: {"workload", "config", "traffic", "limits",
    "end_to_end", "per_layer"}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": w, "config": config,
            "traffic": _json("traffic", f"{w['traffic']}.json"),
            "limits": _json("limits", f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (kind: scenes, loops, e2e,
    metrics)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    tag = re.sub(r"[^A-Za-z0-9_]", "_", f"perfbench_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, kind: str = "metrics"):
    """The ``read`` function of ``<kind>/<metric>.py``."""
    return plugin(kind, metric).read


def layout(config: dict) -> list[dict]:
    """The configuration's scene (see ``lib/geometry.py``): its
    generator's instances, then its lamps."""
    from . import geometry
    scene = config["scene"]
    out = plugin("scenes", scene["generator"]).layout(scene)
    return out + [geometry.quad_instance(q) for q in config.get("lamps", [])]


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the benchmark's own rules of form: names,
    units, sources, the files each name needs, and a cell's ``chips``
    against its configuration's tiles (``render.n_devices``: equal to
    ``chips`` on several cards, at most 1 on one)."""
    out = []
    tiles = {}

    def name_ok(kind, n):
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{kind} name {n!r}")

    def need(*parts):
        if not os.path.exists(os.path.join(HERE, *parts)):
            out.append(f"missing {'/'.join(parts)}")

    for c in bench.get("configs", []):
        name_ok("config", c["name"])
        if not os.path.exists(os.path.join(ROOT, c["file"])):
            out.append(f"config file {c['file']}")
            continue
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        need("scenes", f"{conf['scene']['generator']}.py")
        tiles[c["name"]] = conf.get("render", {}).get("n_devices") or 0
        for k in c.get("reduced", []):
            name_ok("reduced key", k)
    names = {c["name"] for c in bench.get("configs", [])}
    for w in bench.get("workloads", []):
        name_ok("workload", w["name"])
        name_ok("traffic", w["traffic"])
        if w["config"] not in names:
            out.append(f"workload {w['name']} config {w['config']}")
        need("limits", f"{w['name']}.json")
        mix = os.path.join(HERE, "traffic", f"{w['traffic']}.json")
        if os.path.exists(mix):
            with open(mix) as f:
                need("loops", f"{json.load(f)['loop']}.py")
        else:
            need("traffic", f"{w['traffic']}.json")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} chips {w['chips']}")
        n = tiles.get(w["config"], 0)
        if (w["chips"] > 1 and n != w["chips"]) or (w["chips"] == 1
                                                     and n > 1):
            out.append(f"workload {w['name']} chips {w['chips']} "
                       f"n_devices {n}")
    for kind in ("end_to_end", "per_layer"):
        for m in bench.get(kind, []):
            name_ok("metric", m["name"])
            if not UNIT.match(m["unit"]):
                out.append(f"unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"better {m['better']!r}")
            if m["source"] not in SOURCES:
                out.append(f"source {m['source']!r}")
            need("e2e" if kind == "end_to_end" else "metrics",
                 f"{m['name']}.py")
    all_names = ([c["name"] for c in bench.get("configs", [])]
                 + [w["name"] for w in bench.get("workloads", [])]
                 + [m["name"] for k in ("end_to_end", "per_layer")
                    for m in bench.get(k, [])])
    if len(set(all_names)) != len(all_names):
        out.append("duplicate names")
    return out
