#!/usr/bin/env python3
"""Throughput bench of the PyTorch port (rfw_tpu_torch) on one CUDA card.

    python3 bench_torch.py [--engine E] [--samples N] [--windows N]
                           [--width W] [--height H]
                           [--scene standin|quad] [--device cuda|cpu]

The counterpart of ``bench.py``, with its protocol step for step: build
the scene, a 2-sample warm-up frame, ``max(2, windows)`` CONVERGE windows
of ``samples`` samples (``render_frame_async`` then ``finish_frame``,
each window's clock stopped after ``torch.cuda.synchronize()``), the
median window and Mrays/s from RenderStats' four ray counts, the time to
the first pixel of a second RenderSystem in the same process, and the
per-depth split of one ``profile_stages`` frame after a warm one
(``RFW_BENCH_SPLIT=0`` skips it; a frame of one chunk runs the fused
program, which has no per-depth split, and ``stage_ms`` is then null).
Progress goes to stderr; ONE JSON line goes last on stdout.

Scenes: ``standin`` (the default) is the generated stand-in for the
reference bench's 2x2 instanced pica glTF, which is not in this
repository (``rfw_tpu_torch.utils.synthetic.build_slice_scene``: 60
level-4 icospheres, a floor and two walls, 316,802 triangles, seeded);
``quad`` is the reference bench's 2-triangle fallback.

The line has ``bench.py``'s keys but ``vs_baseline`` (its 100 Mrays/s
target was the TPU round's), its numbers unrounded; ``cache_state``
names the port's caches (the kernel library of the current sources, the
scene cache, the texture cache); ``device`` is the card's name and power
limit as nvidia-smi gives them; ``launches`` is each kernel's launches a
sample over the timed windows (``samples_per_window`` samples a
window).

It runs on the card unless ``--device cpu`` is passed, and never falls
back to the CPU: without a card it raises. On the card it exits non-zero
when the timed windows left a kernel of the active intersector
unlaunched (``enum`` and ``visit`` under the default ``visit``).
Environment: ``RFW_BENCH_ENGINE`` (wavefront), ``RFW_BENCH_SAMPLES`` (4)
and ``RFW_BENCH_WINDOWS`` (3) set the flags' defaults;
``RFW_BENCH_PROFILE=1`` renders every frame with ``profile_stages``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib
from rfw_tpu_torch.render import RenderStatus
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.render.context import resolve_device
from rfw_tpu_torch.scene import Skybox
from rfw_tpu_torch.scene import texture
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.utils.synthetic import build_slice_scene

SCENES = ("standin", "quad")
LABELS = {"standin": "pica-4x stand-in", "quad": "procedural quad"}
# the kernels each intersector launches on the card
INTERSECTOR_KERNELS = {"visit": ("enum", "visit"),
                       "tvisit": ("enum", "visit", "expand", "tvisit"),
                       "bvh": ("traverse",),
                       "tlas": ("tlas_premask", "tlas_walk")}


def build_scene(rs, scene: str) -> int:
    """Add ``scene`` (one of SCENES) to ``rs`` with the reference bench's
    lamp quad, test sky and camera; returns its triangle count."""
    if scene == "standin":
        # the PLYs are read as they are added; the lamp, sky and camera
        # are the reference bench's
        with tempfile.TemporaryDirectory() as work:
            return build_slice_scene(rs, work)
    elif scene == "quad":
        m = rs.add_material([0.7, 0.7, 0.7])
        g = rs.add_quad([0, 1, 0], [0, 0, 0], 20, 20, m)
        rs.add_instance(g)
        center, eye = np.zeros(3), np.array([0, 8.0, -12.0])
        n_tris = 2
    else:
        raise ValueError(f"unknown scene {scene!r}: one of {SCENES}")
    lamp = rs.add_material([40.0, 40.0, 40.0])
    gl = rs.add_quad([0, -1, 0], center + np.array([0, 18.0, 0]), 6, 6, lamp)
    rs.add_instance(gl)
    rs.set_skybox(Skybox.test_sky())
    rs.camera.look_at(eye, center)
    return n_tris + 2


def _entries(path) -> int:
    if path is None or not os.path.isdir(path):
        return 0
    return sum(len(files) for _, _, files in os.walk(path))


def _cache_state() -> dict:
    """The port's caches before the run: the kernel library built from
    the current sources (``rfw_tpu_torch/_build/``), the scene cache and
    the texture cache ("off" when its environment switch disables it)."""
    state = {"kernel_library": ("warm" if os.path.exists(
        cuda_lib._library_path()) else "cold")}
    for name, path in (("scene_cache", scene_data._scene_cache_dir()),
                       ("texture_cache", texture._cache_dir())):
        n = _entries(path)
        state[name] = "off" if path is None else ("warm" if n else "cold")
        state[f"{name}_entries"] = n
    return state


def _card(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return {"name": dev.type}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "-i", str(index),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    name, power = smi.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": power.strip()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _intersector(rs) -> str:
    return next(s.value for s in rs.get_available_settings()
                if s.name == "intersector")


def _median(sorted_ms: list) -> float:
    n = len(sorted_ms)
    if n % 2:
        return sorted_ms[n // 2]
    return 0.5 * (sorted_ms[n // 2 - 1] + sorted_ms[n // 2])


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _new_system(engine, config, dev, scene, width, height):
    rs = RenderSystem(engine, config, device=dev)
    n_tris = build_scene(rs, scene)
    rs.camera.resize(width, height)
    rs.camera.fov = 60.0
    rs.synchronize()
    _sync(dev)
    return rs, n_tris


def run(engine: str = "wavefront", samples: int = 4, windows: int = 3,
        width: int = 1920, height: int = 1080, scene: str = "standin",
        device="cuda", profile: bool = False, split: bool = True) -> dict:
    """The bench's protocol; returns the JSON line as a dict."""
    dev = resolve_device(device)
    cache_state = _cache_state()
    card = _card(dev)
    t_setup = time.perf_counter()
    config = RenderConfig(profile_stages=profile)
    t_scene0 = time.perf_counter()
    rs, n_tris = _new_system(engine, config, dev, scene, width, height)
    t_scene = time.perf_counter() - t_scene0

    # warm-up: the kernels' first launches (and their build, when the
    # library of these sources is not on disk) and first samples;
    # samples=2 so a profiled step runs here too
    rs.render_frame(samples=2)
    _sync(dev)
    setup_s = time.perf_counter() - t_setup
    _log(f"# setup+compile {setup_s:.1f}s (scene load+build+upload "
         f"{t_scene:.1f}s)")

    # timed region: >= 2 CONVERGE windows, the headline the median one.
    # finish_frame's read-back syncs the engine's device too; the clock
    # stops after an explicit synchronize all the same
    n_windows = max(2, windows)
    window_ms = []
    t_dispatch = 0.0
    cuda_lib.reset_launch_counts()
    for _ in range(n_windows):
        t0 = time.perf_counter()
        rs.render_frame_async(status=RenderStatus.CONVERGE, samples=samples)
        t_dispatch = time.perf_counter() - t0
        rs.finish_frame()
        _sync(dev)
        window_ms.append((time.perf_counter() - t0) * 1000.0)
    counts = dict(cuda_lib.launch_counts)
    window_ms_sample = sorted(w / samples for w in window_ms)
    med = _median(window_ms_sample)
    spread = window_ms_sample[-1] - window_ms_sample[0]
    _log(f"# dispatch {t_dispatch * 1000:.0f} ms, per-sample windows "
         f"{[round(w) for w in window_ms_sample]} ms (median {med:.0f}, "
         f"spread {spread:.0f})")
    intersector = _intersector(rs)
    if dev.type == "cuda":
        missing = [k for k in INTERSECTOR_KERNELS.get(intersector, ())
                   if counts[k] == 0]
        if missing:
            raise RuntimeError(
                f"bench_torch: the timed windows launched no {missing} "
                f"kernel of the {intersector} intersector: {counts}")

    stats = rs.get_render_stats()
    rays_per_sample = (stats.primary_count + stats.secondary_count
                       + stats.deep_count + stats.shadow_count)
    total_rays = rays_per_sample * samples
    mrays = total_rays / (med * samples / 1000.0) / 1e6
    _log(f"# {med:.0f} ms/sample | rays/sample: "
         f"primary {stats.primary_count / 1e6:.2f}M secondary "
         f"{stats.secondary_count / 1e6:.2f}M deep "
         f"{stats.deep_count / 1e6:.2f}M shadow "
         f"{stats.shadow_count / 1e6:.2f}M")
    rays = {"primary": int(stats.primary_count),
            "secondary": int(stats.secondary_count),
            "deep": int(stats.deep_count),
            "shadow": int(stats.shadow_count),
            "total": int(rays_per_sample)}

    # warm-session time to first pixel: a second RenderSystem in this
    # process (scene build, synchronize, one 1-spp frame; the kernels are
    # loaded, so this is the non-compile part of the first pixel)
    t_warm = time.perf_counter()
    rs2, _ = _new_system(engine, config, dev, scene, width, height)
    rs2.render_frame(samples=1)
    _sync(dev)
    warm_s = time.perf_counter() - t_warm
    del rs2
    _log(f"# warm-session TTFP {warm_s:.1f}s")

    # per-depth split, from the profiled step's syncs after each depth;
    # a warm profiled frame first, then the measured one
    stage_ms = None
    if split and getattr(rs.context, "_driver", None) is not None:
        if not config.profile_stages:
            object.__setattr__(rs.context.config, "profile_stages", True)
            rs.render_frame(status=RenderStatus.CONVERGE, samples=2)
        rs.render_frame(status=RenderStatus.CONVERGE, samples=2)
        st = rs.get_render_stats()
        stage_ms = {"primary": st.primary_time * 1000.0,
                    "secondary": st.secondary_time * 1000.0,
                    "deep": st.deep_time * 1000.0}
        _log(f"# stage ms: {stage_ms}")

    n_samples = n_windows * samples
    return {
        "metric": f"Mrays/sec/chip ({LABELS[scene]}, {n_tris:,} tris, "
                  f"{width}x{height} path trace, {engine})",
        "value": mrays,
        "unit": "Mrays/s",
        "ms_per_sample_median": med,
        "ms_per_sample_windows": window_ms_sample,
        "rays_per_sample": rays,
        "cache_state": cache_state,
        "setup_compile_s": setup_s,
        "scene_build_s": t_scene,
        "warm_session_ttfp_s": warm_s,
        "stage_ms": stage_ms,
        "device": card,
        "samples_per_window": samples,
        "launches": {k: v / n_samples for k, v in counts.items()},
    }


def main(argv=None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default=env("RFW_BENCH_ENGINE", "wavefront"))
    ap.add_argument("--samples", type=int,
                    default=int(env("RFW_BENCH_SAMPLES", "4")))
    ap.add_argument("--windows", type=int,
                    default=int(env("RFW_BENCH_WINDOWS", "3")))
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--scene", choices=SCENES, default="standin")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = run(engine=args.engine, samples=args.samples,
              windows=args.windows, width=args.width, height=args.height,
              scene=args.scene, device=args.device,
              profile=bool(env("RFW_BENCH_PROFILE")),
              split=env("RFW_BENCH_SPLIT", "1") != "0")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
