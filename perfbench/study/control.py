#!/usr/bin/env python3
"""The readings the limits of correctness are set from, for one cell:

    python3 perfbench/study/control.py --workload W --seconds S \\
        --controls K [--faults F,...] --out FILE SEED [SEED ...]

In one process, for each seed, a run of the cell as the benchmark makes
it (set-up, the measured window at the cell's size, the check); for the
first K seeds also a run of the control (the reference computed in
bfloat16 put in the program's place) and a run with each planted fault
of ``FAULTS`` named in ``--faults``. One JSON line a run goes to FILE
and to stdout: what ran, its numbers and ``correct``.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def edit_lost():
    """An instance move that never reaches the scene."""
    from rfw_tpu_torch import refs
    saved = refs.InstanceRef.translate
    refs.InstanceRef.translate = lambda self, off: None
    try:
        yield
    finally:
        refs.InstanceRef.translate = saved


@contextlib.contextmanager
def tlas_stale():
    """A move that updates the world triangles and leaves the TLAS's
    instance tables as they were: the device update takes the scene's
    TLAS tables in place of those ``_moved_tlas`` makes again."""
    from rfw_tpu_torch.render import scene_data
    saved = scene_data._moved_tlas
    scene_data._moved_tlas = lambda scene, instances: scene["tlas"]
    try:
        yield
    finally:
        scene_data._moved_tlas = saved


FAULTS = {"edit_lost": edit_lost, "tlas_stale": tlas_stale}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("seeds", nargs="+", type=int)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import run as runner
    runner.caches()
    from perfbench.lib import harness
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    faults = [f for f in args.faults.split(",") if f]

    def one(seed, what, control=False, fault=None):
        with (FAULTS[fault]() if fault else contextlib.nullcontext()):
            line = harness.run(args.workload, seed, args.seconds, False,
                               time.perf_counter(), device="cuda",
                               log=lambda m: print(m, file=sys.stderr),
                               control=control)
        rec = {"workload": args.workload, "seed": seed, "run": what,
               "correct": line["correct"],
               "numbers": {k: c["value"] for k, c in line["checks"].items()},
               "metrics": {k: m["value"] for k, m in line["metrics"].items()}}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    for i, seed in enumerate(args.seeds):
        one(seed, "program")
        if i < args.controls:
            one(seed, "control", control=True)
            for fault in faults:
                one(seed, fault, fault=fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
