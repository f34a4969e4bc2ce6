#!/usr/bin/env python3
"""Runs one cell of the benchmark of rfw_tpu_torch once, on the CUDA cards
of the machine it is started on (``cuda:0`` to ``cuda:{chips - 1}``):

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` at the root of the checkout (see
``perfbench/README.md``). Progress goes to stderr, whose last lines are
the numbers the check compared, each beside its limit; the last line of
stdout is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.

It exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and when the process has loaded JAX or
the JAX package. The process runs as it is started: no placement or
thread count is set (a study of both narrowed nothing, ``PERF.md``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def caches():
    """Every cache of the program and of the reference at a fixed place
    inside the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ["RFW_SCENE_CACHE_DIR"] = os.path.join(cache, "scene")
    os.environ["RFW_TEX_CACHE_DIR"] = os.path.join(cache, "tex")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    sys.path.insert(0, ROOT)
    from perfbench.lib import bench
    spec = bench.cell(bench.load(), args.workload)

    import torch
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    from perfbench.lib import harness
    line = harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START, device="cuda", log=log)
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
