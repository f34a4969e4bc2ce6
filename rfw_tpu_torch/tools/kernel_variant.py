"""Time a variant of one kernel against the built one, on one card.

    python3 -m rfw_tpu_torch.tools.kernel_variant KERNEL NAME=VALUE [...]

Run from the repository root. KERNEL is ``enum``, ``expand``,
``tvisit``, ``traverse`` or ``tlas`` (both tlas kernels). The variant is
a copy of ``csrc/`` in which each named ``constexpr int NAME = ...;``
takes the given value (for example ``enum kEnumCells=1``: one cell a
thread; ``tvisit kTvisitRays=1``: one ray a thread; ``expand
kExpandSlots=2``: two child slots a work item; ``traverse
kTraverseThreads=64``: blocks of 64 threads; ``tlas kTlasWalkBatch=1``:
one box test before a walk, ``tlas kPremaskBoxes=2``: two box tests a
step). The script builds both libraries, builds chip_smoke.py's 1080p
slice scene (switched to the tvisit intersector for ``expand`` and
``tvisit``; for ``tlas`` phase 10's instanced scene on the tlas
intersector) and takes its phase-3 streams (a primary chunk and a
bounce chunk; for ``expand`` and ``traverse`` also the depth-0 fused
shadow launch; for ``tlas`` the premask and walk launches of the
spheres' BLAS group on the three). On each
stream it holds each library's kernel to its plain version (equal; for
``expand`` and ``tvisit`` on pass 0's parent window, tvisit on the plain
expansion's lists, closest hit; ``traverse`` closest and any hit on the
two chunks, any hit on the shadow launch, bit for bit; ``tlas`` as
chip_smoke.py's phase 10 holds it) and times them in
alternation, built, variant, variant, built (the device time of 20
launches queued behind a device-side wait, chip_smoke._device_ms, median
of 5 each). The last line is one JSON object with the times and both
kernels' ptxas reports.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import tempfile

import torch

from ..ops import cuda_lib

KERNELS = ("enum", "expand", "tvisit", "traverse", "tlas")


def variant_sources(consts: dict, out_dir: str) -> tuple:
    """Copies of the kernel sources (and of their headers) with the named
    constants replaced; each name must occur exactly once across the
    sources."""
    os.makedirs(out_dir, exist_ok=True)
    for h in cuda_lib.headers():
        shutil.copy(h, out_dir)
    hits = dict.fromkeys(consts, 0)
    paths = []
    for src in cuda_lib.SOURCES:
        with open(src) as f:
            text = f.read()
        for name, value in consts.items():
            text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                              rf"\g<1>{value};", text)
            hits[name] += n
        path = os.path.join(out_dir, os.path.basename(src))
        with open(path, "w") as f:
            f.write(text)
        paths.append(path)
    bad = {k: n for k, n in hits.items() if n != 1}
    if bad:
        raise ValueError(f"constants not found exactly once: {bad}")
    return tuple(paths)


def _load(sources: tuple):
    cuda_lib.SOURCES, cuda_lib._lib = sources, None
    lib = cuda_lib.load()
    return lib, cuda_lib.build_log


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _tlas_cases(rs, chip_smoke) -> dict:
    """Per stream of phase 10's chunk 0: (launch, plain result, note,
    equality) of the premask and the walk on the spheres' BLAS group, the
    walk on the built premask's list."""
    from ..bvh import tlas
    _, streams, _, held, _, spheres = chip_smoke.tlas_launches(rs)
    cases = {}
    for name in streams:
        args, out = held.premask[(name, spheres)]
        lo, hi, o, d, best_t, t_eps, orig = args
        cases[f"premask {name}"] = (
            (lambda a=args: tlas.premask(*a)),
            tlas.premask_ref(lo, hi, o, tlas.safe_inv_box_dir(d), best_t,
                             t_eps, orig),
            f"{lo.shape[0]} instances, {int(out[3])} lanes listed",
            chip_smoke._premask_equal)
        args, _ = held.walk[(name, spheres)]
        rows, o, d, state, order, count, _, n_lanes, t_eps, any_hit = args
        cases[f"walk {name}"] = (
            (lambda a=args: tlas.walk_group(*a)),
            tlas.walk_group_ref(rows, o, d, state, order, count, t_eps,
                                any_hit),
            f"{int(count)} touched instances, {int(n_lanes)} lanes listed",
            _equal)
    return cases


def _cases(kernel: str, rs, cfg, chip_smoke) -> dict:
    """Per stream: (launch, plain result, note[, equality]) for the named
    kernel."""
    from ..ops import traverse
    from ..ops import tvisit_intersect as tv
    from ..ops import visit_intersect as vi
    if kernel == "tlas":
        return _tlas_cases(rs, chip_smoke)
    if kernel in ("expand", "tvisit"):
        rs.set_setting("intersector", "tvisit")
    scene, streams, _ = chip_smoke._streams(rs)
    tl = scene["treelets"]
    diag = vi.scene_diag(tl)
    cases = {}
    if kernel == "traverse":
        eps = float(cfg.t_epsilon)
        for name, any_hit in (("primary", False), ("primary", True),
                              ("bounce", False), ("bounce", True),
                              ("shadow", True)):
            o, d, tm = streams[name]
            args = (o, d, scene["bvh"], scene["tri_table"])
            kw = {"t_max": tm, "t_epsilon": eps, "any_hit": any_hit}
            cases[f"{name} {'any-hit' if any_hit else 'closest'}"] = (
                (lambda a=args, k=kw: traverse.traverse_wide(*a, **k)),
                traverse.traverse_wide_ref(*args, **kw),
                f"{int((tm > eps).sum())} live lanes")
        return cases
    for name in ("primary", "bounce", "shadow")[:3 if kernel == "expand"
                                                else 2]:
        o, d, tm = streams[name]
        rays = vi._pack_rays(o, d, tm)
        note = f"{int((tm > 0).sum())} live lanes"
        if kernel == "enum":
            g = vi._granularity(tl, cfg)
            cases[name] = ((lambda r=rays, g=g: vi.block_entries(
                r, g.bounds8, g.n_real)),
                vi.block_entries_ref(rays, g.bounds8),
                f"{note}, {g.n_real} real cells")
            continue
        ids, t_p = chip_smoke.pass0_window(tl, rays, diag)
        bmin32, bmax32, wg32, wtm32, k32 = tv.child_tables(tl)
        args = (ids, rays, bmin32, bmax32, diag, t_p)
        lists = tv.expand_children_ref(*args)
        if kernel == "expand":
            cases[name] = ((lambda a=args: tv.expand_children(*a)), lists,
                           f"{note}, {int((ids < t_p).sum())} valid parents")
            continue
        targs = (rays, *lists, wg32, wtm32, k32, float(cfg.t_epsilon),
                 False)
        cases[name] = ((lambda a=targs: tv.tvisit(*a)),
                       tv.tvisit_ref(rays, *lists, wg32, k32,
                                     float(cfg.t_epsilon), False),
                       f"{note}, mean child list "
                       f"{float(lists[1].float().mean()):.1f}")
    return cases


def main(argv) -> int:
    if len(argv) < 2 or argv[0] not in KERNELS:
        raise SystemExit(__doc__)
    kernel = argv[0]
    consts = dict(a.split("=", 1) for a in argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variant: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from ..config import RenderConfig
    from ..system import RenderSystem

    built = cuda_lib.SOURCES
    names = ((f"{kernel}_kernel",) if kernel != "tlas" else
             ("tlas_premask_kernel", "tlas_walk_kernel"))
    libs, ptxas = {}, {}
    for which, sources in (("built", built), ("variant", variant_sources(
            consts, os.path.join(cuda_lib.BUILD_DIR, "variant_src")))):
        libs[which], log = _load(sources)
        report = cuda_lib.ptxas_report(log)
        ptxas[which] = {name: report.get(name) for name in names}
        print(f"{which}: ptxas {ptxas[which]}")

    cuda_lib._lib = libs["built"]
    cfg = RenderConfig()
    with tempfile.TemporaryDirectory() as work:
        if kernel == "tlas":
            rs = chip_smoke._tlas_system(work)[0]
            rs.set_setting("intersector", "tlas")
        else:
            rs = RenderSystem("wavefront", cfg, device="cuda")
            chip_smoke.build_slice_scene(rs, work)
        rs.synchronize()
    # a launch can be shorter than its wrapper's host work: the device
    # time, from queued launches
    timer = chip_smoke._device_ms
    times = {}
    for name, (run, ref, note, *eq) in _cases(kernel, rs, cfg,
                                              chip_smoke).items():
        equal = eq[0] if eq else _equal
        times[name] = {k: [] for k in libs}
        for which in ("built", "variant", "variant", "built"):
            cuda_lib._lib = libs[which]
            chip_smoke._check(equal(run(), ref),
                              f"{which} {kernel} kernel != plain on {name}")
            times[name][which].append(timer(run))
        print(f"{name}: {kernel} built {times[name]['built']} ms, variant "
              f"{times[name]['variant']} ms ({note})")
    print(json.dumps({"kernel": kernel, "variant": consts, "ms": times,
                      "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
