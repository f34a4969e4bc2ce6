"""Time one checkout's traversal kernel on chip_smoke.py's phase-3
streams, on one card, by both of chip_smoke.py's timers.

    python3 rfw_tpu_torch/tools/traverse_times.py ROOT

Run as a script from this repository's root. ROOT is a checkout of the
repository: this one (``.``) or an earlier commit unpacked with ``git
archive`` into a directory that .gitignore lists. The script imports
ROOT's rfw_tpu_torch and chip_smoke.py, builds ROOT's kernels and its
1080p slice scene, and on each of ROOT's phase-3 streams (the primary and
bounce chunks, closest and any hit; the depth-0 fused shadow launch, any
hit, where ROOT's chip_smoke.py has it) holds ROOT's kernel bit for bit
to ROOT's traverse_wide_ref and times it with this checkout's timers:
CUDA events around one launch (chip_smoke._median_ms) and the device
time of 20 launches queued behind a device-side wait
(chip_smoke._device_ms), median of 5 each. The triangles are the
scene's ``tri_table`` where ROOT derives one, else the (v0, e1, e2)
tuple that the kernel's first version took. To compare two checkouts,
run it for parent, change, change, parent in one chip command. The last
two lines are the card's name and power limit as nvidia-smi gives them
and one JSON object of the times.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _timers():
    """This checkout's chip_smoke.py, loaded under a name of its own so
    that ROOT's may be imported beside it."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    root = os.path.abspath(argv[0])
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("traverse_times: no CUDA device")
    timers = _timers()
    os.environ["RFW_NO_TEX_CACHE"] = "1"
    os.environ["RFW_NO_SCENE_CACHE"] = "1"
    sys.path.insert(0, root)
    import chip_smoke
    import rfw_tpu_torch
    from rfw_tpu_torch.config import RenderConfig
    from rfw_tpu_torch.ops import traverse
    from rfw_tpu_torch.system import RenderSystem
    for mod in (chip_smoke, rfw_tpu_torch):
        timers._check(os.path.abspath(mod.__file__).startswith(root + os.sep),
                      f"{mod.__name__} imported from outside {root}")

    cfg = RenderConfig()
    rs = RenderSystem("wavefront", cfg, device="cuda")
    with tempfile.TemporaryDirectory() as work:
        chip_smoke.build_slice_scene(rs, work)
        rs.synchronize()
    scene, streams, _ = chip_smoke._streams(rs)
    if "tri_table" in scene:
        tris = scene["tri_table"]
    else:
        v = scene["tri_vertices"]
        tris = (v[:, 0].contiguous(), (v[:, 1] - v[:, 0]).contiguous(),
                (v[:, 2] - v[:, 0]).contiguous())
    eps = float(cfg.t_epsilon)
    times = {}
    for name, (o, d, tm) in streams.items():
        for any_hit in ((True,) if name == "shadow" else (False, True)):
            mode = f"{name} {'any-hit' if any_hit else 'closest'}"

            def kernel():
                return traverse.traverse_wide(o, d, scene["bvh"], tris,
                                              t_max=tm, t_epsilon=eps,
                                              any_hit=any_hit)

            ref = traverse.traverse_wide_ref(o, d, scene["bvh"], tris,
                                             t_max=tm, t_epsilon=eps,
                                             any_hit=any_hit)
            timers._check(_bits_equal(kernel(), ref),
                          f"traverse kernel != plain on {mode}")
            times[mode] = {"ms": timers._median_ms(kernel),
                           "device_ms": timers._device_ms(kernel)}
            print(f"{mode}: equal bit for bit, one launch "
                  f"{times[mode]['ms']:.4f} ms, device "
                  f"{times[mode]['device_ms']:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"root": argv[0], "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
