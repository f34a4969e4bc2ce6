#!/usr/bin/env python3
"""Runs cells of the benchmark one after another, each in a fresh process
as the check runs them, and keeps every run's result line:

    python3 perfbench/study/runs.py --out DIR RUN [RUN ...]

A RUN is ``workload:seed:seconds:trace``. Each run's stdout
and stderr go to ``DIR/<n>.out`` and ``DIR/<n>.err``; ``DIR/runs.jsonl``
gets one line a run (the run, its exit code, wall seconds and result
line), and a one-line summary a run is printed. Used for the spread
sets and the trials of a new cell.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "runs.jsonl"), "a") as log:
        for n, spec in enumerate(args.runs):
            workload, seed, seconds, trace = spec.split(":")
            cmd = [sys.executable, os.path.join(HERE, "run.py"),
                   "--workload", workload, "--seed", seed,
                   "--seconds", seconds, "--trace", trace]
            t0 = time.perf_counter()
            with open(os.path.join(args.out, f"{n}.out"), "w") as out, \
                    open(os.path.join(args.out, f"{n}.err"), "w") as err:
                try:
                    rc = subprocess.run(cmd, stdout=out, stderr=err,
                                        timeout=args.timeout).returncode
                except subprocess.TimeoutExpired:
                    rc = 124
            wall = time.perf_counter() - t0
            with open(os.path.join(args.out, f"{n}.out")) as f:
                lines = f.read().strip().splitlines()
            try:
                line = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                line = None
            log.write(json.dumps({"run": spec, "rc": rc, "wall_s": wall,
                                  "line": line}) + "\n")
            log.flush()
            short = None
            if line:
                short = {"correct": line["correct"],
                         **{k: v["value"] for k, v in line["metrics"].items()},
                         **{k: v["value"] for k, v in
                            line.get("checks", {}).items()}}
            print(f"{spec} rc={rc} wall={wall:.1f} {json.dumps(short)}",
                  flush=True)
            if rc != 0:
                with open(os.path.join(args.out, f"{n}.err")) as f:
                    print(f.read()[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
