"""Time bench_torch.py's protocol against chip_smoke.py phase 5's on the
same scene and card, each with its own warm-up and with the other's, in
fresh processes that take turns.

    python3 -m rfw_tpu_torch.tools.bench_protocols [--rounds N] [--out PATH]

Run from this repository's root, on the card. The four variants:

* ``bench``: ``bench_torch.run`` at its defaults without the per-depth
  split (``split=False``): a 2-sample RESET warm-up frame, then 3
  CONVERGE windows of 4 samples;
* ``bench_p5warm``: the same, its warm-up frame replaced by phase 5's
  (one RESET sample);
* ``phase5``: chip_smoke.py's phase-5 system (``build_slice_scene`` on a
  fresh ``RenderSystem``) and ``chip_smoke.phase_slice``: one RESET
  sample, then the same windows;
* ``phase5_benchwarm``: the same, its warm-up replaced by the bench's
  (a 2-sample RESET frame).

Each runs in a process of its own with the texture and scene caches off
(as chip_smoke.py runs), ``--rounds`` rounds (default 3), the order
rotated by one each round. In every process the windows are timed alike
around ``RenderSystem.render_frame_async`` and ``finish_frame``: each
window's wall ms a sample, the host's ms in ``render_frame_async``
(dispatch) and in ``finish_frame`` (wait), and the process's CPU ms.
Meanwhile ``nvidia-smi`` logs the card's SM clock, power draw, temperature and
utilization every 250 ms; each window gets the means of the samples
inside it. The last two lines are the card's name and power
limit as nvidia-smi gives them and one JSON object of each variant's
medians; the full record goes to ``--out``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

VARIANTS = ("bench", "bench_p5warm", "phase5", "phase5_benchwarm")
WINDOW_SAMPLES = 4
SMI_FIELDS = ("clocks.sm", "power.draw", "temperature.gpu",
              "utilization.gpu")


def _time_windows(record: list) -> None:
    """Record every CONVERGE frame of WINDOW_SAMPLES samples (the two
    protocols' windows) into ``record``."""
    import torch
    from ..render import RenderStatus
    from ..system import RenderSystem
    render_async, finish = (RenderSystem.render_frame_async,
                            RenderSystem.finish_frame)
    open_window = {}

    def timed_async(self, camera=None, status=None, samples=1):
        t0, c0, start = time.perf_counter(), time.process_time(), time.time()
        render_async(self, camera, status, samples)
        if status == RenderStatus.CONVERGE and samples == WINDOW_SAMPLES:
            open_window.update(t0=t0, c0=c0, start=start,
                               dispatch=time.perf_counter() - t0)

    def timed_finish(self):
        t1 = time.perf_counter()
        out = finish(self)
        if open_window:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            w = dict(open_window)
            open_window.clear()
            record.append({
                "ms": (t2 - w["t0"]) * 1e3 / WINDOW_SAMPLES,
                "dispatch_ms": w["dispatch"] * 1e3,
                "wait_ms": (t2 - t1) * 1e3,
                "cpu_ms": (time.process_time() - w["c0"]) * 1e3,
                "start": w["start"], "end": time.time()})
        return out

    RenderSystem.render_frame_async = timed_async
    RenderSystem.finish_frame = timed_finish


def _first_frame_as(**kwargs) -> None:
    """Render the process's first ``RenderSystem.render_frame`` call, the
    protocol's warm-up, with ``kwargs`` instead of its own arguments."""
    from ..system import RenderSystem
    render = RenderSystem.render_frame
    done = []

    def swapped(self, camera=None, status=None, samples=1):
        if not done:
            done.append(True)
            return render(self, camera, **kwargs)
        return render(self, camera, status, samples)

    RenderSystem.render_frame = swapped


def child(variant: str) -> dict:
    """One variant in this process; returns its windows."""
    from ..render import RenderStatus
    windows = []
    _time_windows(windows)
    if variant == "bench_p5warm":
        _first_frame_as(status=RenderStatus.RESET, samples=1)
    elif variant == "phase5_benchwarm":
        _first_frame_as(samples=2)
    if variant.startswith("bench"):
        import bench_torch
        line = bench_torch.run(split=False)
        own = line["ms_per_sample_windows"]
    else:
        import chip_smoke
        from ..config import RenderConfig
        from ..system import RenderSystem
        rs = RenderSystem("wavefront", RenderConfig(), device="cuda")
        with tempfile.TemporaryDirectory() as work:
            n_tris = chip_smoke.build_slice_scene(rs, work)
            rs.synchronize()
        chip_smoke.phase_slice(rs, n_tris, "phase 5", None, False,
                               ("enum", "visit"))
        own = None
    return {"variant": variant, "windows": windows, "own_windows": own}


def _smi_log(path: str) -> subprocess.Popen:
    with open(path, "w") as f:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp," + ",".join(SMI_FIELDS),
             "--format=csv,noheader,nounits", "-lms", "250"], stdout=f)


def _read_smi(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 1 + len(SMI_FIELDS):
                continue
            try:
                at = datetime.datetime.strptime(
                    parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                rows.append((at, [float(p) for p in parts[1:]]))
            except ValueError:
                continue
    return rows


def _median(xs: list) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=".bench/bench_protocols.json")
    ap.add_argument("--child", choices=VARIANTS, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    build = subprocess.run([sys.executable, "-m",
                            "rfw_tpu_torch.native.build"],
                           capture_output=True, text=True, timeout=900)
    if build.returncode:
        raise SystemExit(f"the kernel build failed:\n{build.stdout}"
                         f"{build.stderr}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RFW_BENCH_")}
    env.update(RFW_NO_TEX_CACHE="1", RFW_NO_SCENE_CACHE="1")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    smi_path = os.path.join(out_dir, "bench_protocols_smi.csv")
    logger = _smi_log(smi_path)
    runs = []
    try:
        for r in range(args.rounds):
            k = r % len(VARIANTS)
            order = VARIANTS[k:] + VARIANTS[:k]
            for variant in order:
                p = subprocess.run(
                    [sys.executable, "-m", "rfw_tpu_torch.tools."
                     "bench_protocols", "--child", variant], env=env,
                    capture_output=True, text=True, timeout=600)
                if p.returncode:
                    raise SystemExit(f"{variant} exited {p.returncode}:\n"
                                     f"{p.stdout}{p.stderr}")
                run = json.loads(p.stdout.strip().splitlines()[-1])
                run["round"] = r
                runs.append(run)
                ms = [round(w["ms"], 1) for w in run["windows"]]
                print(f"round {r} {variant}: windows {ms}", flush=True)
    finally:
        logger.terminate()
        logger.wait(timeout=30)

    samples = _read_smi(smi_path)
    for run in runs:
        for w in run["windows"]:
            inside = [v for at, v in samples if w["start"] <= at <= w["end"]]
            if inside:
                w.update({f: sum(v[i] for v in inside) / len(inside)
                          for i, f in enumerate(SMI_FIELDS)})
    keys = ("ms", "dispatch_ms", "cpu_ms") + SMI_FIELDS
    summary = {variant: {key: [
        _median([w[key] for w in run["windows"] if key in w] or [None])
        for run in runs if run["variant"] == variant] for key in keys}
        for variant in VARIANTS}
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs, "summary": summary}, f,
                  indent=1)
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
