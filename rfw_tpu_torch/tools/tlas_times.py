"""Time an earlier checkout's two tlas kernels against this one's, on one
card, on the same tensors and the same device timer, and run the tlas
slice once on each.

    python3 -m rfw_tpu_torch.tools.tlas_times PARENT_ROOT

Run from this repository's root. PARENT_ROOT is an earlier checkout
unpacked with ``git archive`` into a directory that .gitignore lists.
The script builds PARENT_ROOT's kernel library beside this checkout's
(``expand_times.parent_library``). Where PARENT_ROOT's
``rfw_tpu_torch/csrc/tlas_kernel.cu`` takes the list of walking lanes,
as this one does, its kernels run through this checkout's wrappers
(``expand_times.using``); where it has the C interface from before the
list, ``rfw_tlas_premask`` (origins, directions, best_t, n, bmin, bmax,
k, cross, tn_min, stream) and ``rfw_tlas_walk`` (this one's arguments
without ``lanes`` and ``n_lanes``), the two entries are bound to that
interface (``bind_parent``, ``parent_walk_groups``). It builds
chip_smoke.py's phase-10 system (the instanced slice on the tlas
intersector) and catches every
premask and walk launch of its chunk-0 streams (primary and bounce
closest hit, the depth-0 shadow launch any hit; one of each a BLAS
group, ``chip_smoke.tlas_launches``). On each launch both kernels must
equal premask_ref (cross, tn_min) and walk_group_ref (t, orig, u, v),
then ``ab_device_ms`` times them in the order parent, change, change,
parent with ``chip_smoke._device_ms`` (20 launches queued behind a
device-side wait, median of 5). Then it runs chip_smoke.py's slice
protocol (``chip_smoke.phase_slice``: a warm-up sample, then 3 CONVERGE
windows of 4 samples) on the parent's kernels and on this one's: both
must launch each tlas kernel as many times and give the same frame, bit
for bit. The last two lines are the card's name and power limit as
nvidia-smi gives them and one JSON object of the times, launch counts,
ptxas reports and resident blocks per SM.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

from ..ops import cuda_lib
from .expand_times import ab_device_ms, parent_library, using


def takes_list(root: str) -> bool:
    """Whether ROOT's tlas kernels take the premask's list of walking
    lanes, with this checkout's C interface."""
    path = os.path.join(root, "rfw_tpu_torch", "csrc", "tlas_kernel.cu")
    with open(path) as f:
        return "n_lanes" in f.read()


def on(lib, fn, args):
    """``fn(*args)`` with every kernel launch routed to ``lib``."""
    with using(lib):
        return fn(*args)


def bind_parent(lib) -> None:
    """The two tlas entries of a parent from before the list, with their
    C interface."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rfw_tlas_premask.argtypes = [p, p, p, i, p, p, i, p, p, p]
    lib.rfw_tlas_walk.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, p, p,
                                  p, p, i, f, i, p, p, p, p, p]


def parent_premask(lib, lo, hi, o, d, best_t):
    """The parent's ``tlas_premask_kernel``: (cross, tn_min)."""
    import torch
    from ..bvh.tlas import BIG_T
    from ..ops.cuda_lib import launch_counts, ptr
    k, n = lo.shape[0], o.shape[0]
    cross = torch.zeros(k, dtype=torch.int32, device=o.device)
    tn_min = torch.full((k,), BIG_T, device=o.device)
    with cuda_lib.launch(o.device) as (_, stream):
        cuda_lib.check(lib.rfw_tlas_premask(
            ptr(o), ptr(d), ptr(best_t), n, ptr(lo), ptr(hi), k, ptr(cross),
            ptr(tn_min), stream), "parent's tlas premask kernel")
    launch_counts["tlas_premask"] += 1
    return cross.bool(), tn_min


def parent_walk(lib, rows, o, d, state, order, count, t_epsilon, any_hit):
    """The parent's ``tlas_walk_kernel`` (a thread a lane over every
    lane): the new state."""
    import torch
    from ..bvh import tlas
    from ..ops import traverse
    from ..ops.cuda_lib import launch_counts, ptr
    n = o.shape[0]
    out = (torch.empty(n, device=o.device),
           torch.empty(n, dtype=torch.int32, device=o.device),
           torch.empty(n, device=o.device), torch.empty(n, device=o.device))
    with cuda_lib.launch(o.device) as (_, stream):
        cuda_lib.check(lib.rfw_tlas_walk(
            ptr(o), ptr(d), n, *(ptr(x) for x in state), ptr(order),
            ptr(count), *(ptr(b) for b in tlas.group_buffers(rows)),
            traverse.LEAF_SIZE, float(t_epsilon), int(any_hit),
            *(ptr(x) for x in out), stream), "parent's tlas walk kernel")
    launch_counts["tlas_walk"] += 1
    return out


def parent_run(lib, with_list: bool, kernel: str, args):
    """The parent's ``kernel`` ("premask" or "walk") on the arguments
    ``args`` of one of this checkout's held launches of it."""
    from ..bvh import tlas
    if with_list:
        return on(lib, tlas.premask if kernel == "premask"
                  else tlas.walk_group, args)
    if kernel == "premask":
        return parent_premask(lib, *args[:5])
    rows, o, d, state, order, count, _, _, t_eps, any_hit = args
    return parent_walk(lib, rows, o, d, state, order, count, t_eps,
                       any_hit)


@contextlib.contextmanager
def parent_walk_groups(lib):
    """Route ``bvh.tlas.walk_groups`` through the parent's two kernels
    inside the block: premask, ``visit_order`` and walk a BLAS group."""
    from ..bvh import tlas
    saved = tlas.walk_groups

    def walk_groups(tables, o, d, t_max, t_epsilon, any_hit=False,
                    ray_chunk=65536):
        o, d = o.contiguous(), d.contiguous()
        state = tlas.start_state(o, t_max)
        for rows in tables["blas"]:
            cross, tn_min = parent_premask(lib, rows["inst_bmin"],
                                           rows["inst_bmax"], o, d, state[0])
            order, count = tlas.visit_order(cross, tn_min)
            state = parent_walk(lib, rows, o, d, state, order, count,
                                t_epsilon, any_hit)
        return state

    tlas.walk_groups = walk_groups
    try:
        yield
    finally:
        tlas.walk_groups = saved


def premask_equal(got, want) -> bool:
    """A premask result equal to premask_ref's ``want``: this checkout's
    (cross, tn_min, lanes, n_lanes) as ``chip_smoke._premask_equal``
    holds it, the parent's (cross, tn_min) bit for bit."""
    import torch
    import chip_smoke
    if len(got) == 4:
        return chip_smoke._premask_equal(got, want)
    return (torch.equal(got[0], want[0])
            and torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32)))


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tlas_times: no CUDA device")
    os.environ["RFW_NO_TEX_CACHE"] = "1"
    os.environ["RFW_NO_SCENE_CACHE"] = "1"
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from ..bvh import tlas

    lib = cuda_lib.load()
    report = cuda_lib.ptxas_report(cuda_lib.build_log)
    ptxas = {"change": {k: report.get(f"{k}_kernel")
                        for k in chip_smoke.TLAS_KERNELS}}
    parent, report = parent_library(argv[0], None)
    ptxas["parent"] = {k: report.get(f"{k}_kernel")
                       for k in chip_smoke.TLAS_KERNELS}
    with_list = takes_list(argv[0])
    if not with_list:
        bind_parent(parent)
    blocks = tlas.occupancy(lib)
    print(f"ptxas: {ptxas}; this checkout's resident blocks per SM: "
          f"{blocks}")
    with tempfile.TemporaryDirectory() as work:
        rs, n_tris, _ = chip_smoke._tlas_system(work)
        rs.set_setting("intersector", "tlas")
        rs.synchronize()
    held = chip_smoke.tlas_launches(rs)[3]
    times = {}
    for (name, g), (args, _) in sorted(held.premask.items()):
        lo, hi, o, d, best_t, t_eps, orig = args
        plain = tlas.premask_ref(lo, hi, o, tlas.safe_inv_box_dir(d), best_t,
                                 t_eps, orig)
        runs = {"parent": lambda a=args: parent_run(parent, with_list,
                                                    "premask", a),
                "change": lambda a=args: tlas.premask(*a)}
        times[f"premask {name} {g}"] = ab_device_ms(
            runs, plain, chip_smoke._device_ms, chip_smoke._check,
            premask_equal)
    for (name, g), (args, _) in sorted(held.walk.items()):
        rows, o, d, state, order, count, _, _, t_eps, any_hit = args
        plain = tlas.walk_group_ref(rows, o, d, state, order, count, t_eps,
                                    any_hit)
        runs = {"parent": lambda a=args: parent_run(parent, with_list,
                                                    "walk", a),
                "change": lambda a=args: tlas.walk_group(*a)}
        times[f"walk {name} {g}"] = ab_device_ms(
            runs, plain, chip_smoke._device_ms, chip_smoke._check,
            chip_smoke._bits_equal)
    for key, t in times.items():
        print(f"{key}: equal, device ms parent {t['parent']}, change "
              f"{t['change']}")
    launches, frames = {}, {}
    for which in ("parent", "change"):
        ctx = (contextlib.nullcontext() if which == "change"
               else using(parent) if with_list
               else parent_walk_groups(parent))
        with ctx:
            got, frames[which] = chip_smoke.phase_slice(
                rs, n_tris, f"tlas slice, {which}'s kernels", None, False,
                chip_smoke.TLAS_KERNELS)
        launches[which] = {k: got[k] for k in chip_smoke.TLAS_KERNELS}
    equal = bool(np.array_equal(frames["parent"], frames["change"]))
    print(f"tlas slice: launches in the timed windows: parent "
          f"{launches['parent']}, change {launches['change']}; frames equal "
          f"bit for bit: {equal}")
    chip_smoke._check(launches["parent"] == launches["change"],
                      "the two kernel pairs took other launch counts")
    chip_smoke._check(equal, "the two kernel pairs gave other frames")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"parent": argv[0], "device_ms": times,
                      "launches": launches, "ptxas": ptxas,
                      "blocks_per_sm": blocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
