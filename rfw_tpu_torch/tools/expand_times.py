"""Time an earlier checkout's child-expansion kernel against this one's,
on one card, on the same tensors and the same device timer, and run the
tvisit slice once on each.

    python3 -m rfw_tpu_torch.tools.expand_times PARENT_ROOT

Run from this repository's root. PARENT_ROOT is an earlier checkout
unpacked with ``git archive`` into a directory that .gitignore lists; its
``rfw_tpu_torch/csrc/`` must export ``rfw_expand`` with this checkout's C
interface. The script builds PARENT_ROOT's kernel library beside this
checkout's (``parent_library``), builds chip_smoke.py's 1080p slice
scene, switches it to the tvisit intersector and takes
``chip_smoke.expansion_windows`` (pass 0 and pass 1 of the primary,
bounce and depth-0 shadow streams, and the made-up windows on the bounce
rays). On each window both kernels must equal ``expand_children_ref``
(cids, counts, tnears), then ``ab_device_ms`` times them in the order
parent, change, change, parent with ``chip_smoke._device_ms`` (20
launches queued behind a device-side wait, median of 5). Then it runs
chip_smoke.py's phase-6 protocol (``chip_smoke.phase_slice``: a warm-up
sample, then 3 CONVERGE windows of 4 samples) on the parent's kernel and
on this one: both must launch the expansion kernel as many times and
give the same frame, bit for bit. The last two lines are the card's name
and power limit as nvidia-smi gives them and one JSON object of the
times, launch counts and ptxas reports.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile

from ..ops import cuda_lib


def parent_library(root: str, kernel: str | None = "expand_kernel"):
    """(library, ptxas report of its ``kernel``, of every kernel for
    None) built from ROOT's ``rfw_tpu_torch/csrc/`` into this checkout's
    build directory; the loaded library of this checkout stays as it
    was."""
    csrc = os.path.join(os.path.abspath(root), "rfw_tpu_torch", "csrc")
    saved = (cuda_lib.SOURCES, cuda_lib._lib, cuda_lib.build_log,
             cuda_lib.build_seconds)
    cuda_lib.SOURCES = tuple(os.path.join(csrc, os.path.basename(s))
                             for s in saved[0])
    cuda_lib._lib = None
    try:
        lib = cuda_lib.load()
        report = cuda_lib.ptxas_report(cuda_lib.build_log)
        if kernel is not None:
            report = report.get(kernel)
    finally:
        (cuda_lib.SOURCES, cuda_lib._lib, cuda_lib.build_log,
         cuda_lib.build_seconds) = saved
    return lib, report


@contextlib.contextmanager
def using(lib):
    """Route every kernel launch to ``lib`` inside the block."""
    saved = cuda_lib._lib
    cuda_lib._lib = lib
    try:
        yield
    finally:
        cuda_lib._lib = saved


def ab_device_ms(runs: dict, plain, timer, check, equal) -> dict:
    """Device ms of ``runs["parent"]`` and ``runs["change"]`` (each a
    launch of no argument) in the order parent, change, change, parent;
    each ``equal`` to ``plain`` before it is timed."""
    import torch
    times = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        got = runs[which]()
        torch.cuda.synchronize()
        check(equal(got, plain), f"{which}'s kernel != plain")
        times[which].append(timer(runs[which]))
    return times


def _expand_on(lib, args):
    """The expansion kernel of ``lib`` on ``args``."""
    from ..ops import tvisit_intersect as tv
    with using(lib):
        return tv.expand_children(*args)


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("expand_times: no CUDA device")
    os.environ["RFW_NO_TEX_CACHE"] = "1"
    os.environ["RFW_NO_SCENE_CACHE"] = "1"
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from ..config import RenderConfig
    from ..ops import tvisit_intersect as tv
    from ..ops import visit_intersect as vi
    from ..system import RenderSystem

    lib = cuda_lib.load()
    ptxas = {"change": cuda_lib.ptxas_report(cuda_lib.build_log).get(
        "expand_kernel")}
    parent, ptxas["parent"] = parent_library(argv[0])
    print(f"ptxas expand_kernel: {ptxas}; this kernel's resident blocks "
          f"per SM: {tv.expand_occupancy(lib)}")
    cfg = RenderConfig()
    rs = RenderSystem("wavefront", cfg, device="cuda")
    with tempfile.TemporaryDirectory() as work:
        n_tris = chip_smoke.build_slice_scene(rs, work)
        rs.synchronize()
    rs.set_setting("intersector", "tvisit")
    scene, streams, _ = chip_smoke._streams(rs)
    tl = scene["treelets"]
    bmin32, bmax32 = tv.child_tables(tl)[:2]
    diag = vi.scene_diag(tl)
    times = {}
    for name, (ids, rays, t_p) in chip_smoke.expansion_windows(
            tl, streams, diag).items():
        args = (ids, rays, bmin32, bmax32, diag, t_p)
        plain = tv.expand_children_ref(*args)
        runs = {"parent": lambda a=args: _expand_on(parent, a),
                "change": lambda a=args: _expand_on(lib, a)}
        times[name] = ab_device_ms(
            runs, plain, chip_smoke._device_ms, chip_smoke._check,
            lambda got, want: all(torch.equal(x, y)
                                  for x, y in zip(got, want)))
        print(f"{name}: equal, device ms parent {times[name]['parent']}, "
              f"change {times[name]['change']}")
    launches, frames = {}, {}
    for which, which_lib in (("parent", parent), ("change", lib)):
        with using(which_lib):
            got, frames[which] = chip_smoke.phase_slice(
                rs, n_tris, f"tvisit slice, {which}'s expansion kernel",
                None, False, ("expand", "tvisit"))
        launches[which] = got["expand"]
    same = bool(np.array_equal(frames["parent"], frames["change"]))
    print(f"tvisit slice: expand launches in the timed windows: parent "
          f"{launches['parent']}, change {launches['change']}; frames equal "
          f"bit for bit: {same}")
    chip_smoke._check(launches["parent"] == launches["change"],
                      "the two expansion kernels took other launch counts")
    chip_smoke._check(same, "the two expansion kernels gave other frames")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"parent": argv[0], "device_ms": times,
                      "expand_launches": launches, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
