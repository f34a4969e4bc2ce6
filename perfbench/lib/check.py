"""Whether what the timed path produced is correct: the program's
answers against the plain reference (``reference.tracer``), after the
window has closed and the program's state is freed.

The numbers compared, each against its limit in ``limits/<cell>.json``:

* ``closest_mismatch``: over a seeded sample of the closest-hit rays
  the window's intersector calls were given, the share whose answer
  differs from the reference: hit against miss, or a hit distance off
  by more than ``T_REL`` relative;
* ``anyhit_mismatch``: the same share for the any-hit (occlusion) rays;
* ``frame_l1``: over a seeded sample of pixels, the frame the run read
  back last against the reference's frame of the same samples, as the
  summed absolute gap over the summed reference;
* after edits, ``update_gap``: the largest gap, in scene units, between
  a world-space vertex the program holds after the last edit and the
  reference's, matched by the program's (instance, triangle) labels;
* after edits, ``moved_ray_mismatch``: the share of mismatches (either
  kind) over the rays kept because they meet the instance an edit had
  just moved, before or after the move;
* after edits, ``moved_frame_l1``: ``frame_l1`` over the pixels whose
  centre's primary ray meets an instance the edits moved, at its place
  before the edits or after them.

``correct`` holds when every number is within its limit (``verdict``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..reference import tracer
from . import bench, geometry

T_REL = 1e-4
CACHE = os.path.join(bench.HERE, ".cache", "reference")


def verdict(checks: dict) -> bool:
    """Whether every compared number is within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def translations_at(layout, moves, version: int) -> dict:
    """The instances' translations after the first ``version`` moves,
    accumulated in float32 as the program's instance handles do."""
    out = {}
    for inst, off in moves[:version]:
        base = out.get(inst, np.asarray(layout[inst]["translation"],
                                        np.float32))
        out[inst] = (base + np.asarray(off, np.float32)).astype(np.float32)
    return out


def moved_spheres(layout, moves) -> list:
    """(centre, radius) of every instance the moves touched, at its
    place and at its last."""
    out = []
    for inst, tr in translations_at(layout, moves, len(moves)).items():
        c, r = geometry.bounding_sphere(layout[inst])
        out += [(c, r), (c + tr - layout[inst]["translation"], r)]
    return out


def focus_pixels(conf, eye, spheres, rng, n: int) -> np.ndarray:
    """A seeded sample of ``n`` pixels whose centre's primary ray meets
    one of ``spheres``."""
    view = tracer.camera_view(conf["camera"], eye, conf["width"],
                              conf["height"])
    w, h = conf["width"], conf["height"]
    xs = (np.arange(w) + 0.5) / w
    ys = (np.arange(h) + 0.5) / h
    right = view["p2"].astype(np.float64) - view["p1"]
    up = view["p3"].astype(np.float64) - view["p1"]
    pt = (view["p1"][None, None, :] + ys[:, None, None] * up
          + xs[None, :, None] * right).reshape(-1, 3)
    d = pt - view["pos"].astype(np.float64)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = np.zeros(len(d), bool)
    for c, r in spheres:
        oc = np.asarray(c, np.float64) - view["pos"]
        t = np.maximum(d @ oc, 0.0)
        hit |= ((t[:, None] * d - oc) ** 2).sum(-1) <= (r * 1.01) ** 2
    cand = np.nonzero(hit)[0]
    return np.sort(rng.choice(cand, min(n, len(cand)), replace=False))


def _rows(calls, kind, versions, focused):
    rows = [(v, o, d, tm, ans, ok) for k, v, f, o, d, tm, ans, ok in calls
            if k == kind and v in versions and f == focused]
    if not rows:
        return None
    ver = np.concatenate([np.full(len(o), v) for v, o, *_ in rows])
    o, d, tm, ans = (torch.cat([r[i] for r in rows]).numpy()
                     for i in range(1, 5))
    ok = np.concatenate([np.ones(len(r[1]), bool) if r[5] is None
                         else r[5].numpy() for r in rows])
    return ver[ok], o[ok], d[ok], tm[ok], ans[ok]


def _sample(rows, rng, n):
    keep = np.sort(rng.choice(len(rows[0]), min(len(rows[0]), n),
                              replace=False))
    return tuple(x[keep] for x in rows)


def plan(mix, cap_calls, state, conf, layout, eye, seed):
    """What is compared: the scene versions, per set (``sample`` and,
    after edits, ``moved``) and kind the sampled rays (numpy), and the
    sampled pixels (``frame`` and ``moved_frame``)."""
    rng = np.random.default_rng([seed, 3])
    chk = mix["check"]
    calls = [(k, v, f, *(t.cpu() for t in rest[:4]),
              None if rest[4] is None else rest[4].cpu())
             for k, v, f, *rest in cap_calls]
    versions = sorted({c[1] for c in calls})
    if len(versions) > chk.get("versions", len(versions)):
        last = versions[-1]
        pick = rng.choice(versions[:-1], chk["versions"] - 1, replace=False)
        versions = sorted([*pick.tolist(), last])
    rays = {}
    for kind in ("closest", "any"):
        for group, focused, n in (("sample", False, chk["rays"]),
                                  ("moved", True, chk.get("moved_rays", 0))):
            rows = _rows(calls, kind, versions, focused)
            if rows is not None and len(rows[0]) and n:
                rays[(group, kind)] = _sample(rows, rng, n)
    n_pix = conf["width"] * conf["height"]
    pixels = {"frame": np.sort(rng.choice(n_pix, min(n_pix, chk["pixels"]),
                                          replace=False))}
    if state.get("moves") and chk.get("moved_pixels"):
        pixels["moved_frame"] = focus_pixels(
            conf, eye, moved_spheres(layout, state["moves"]), rng,
            chk["moved_pixels"])
    return versions, rays, pixels


def answers(scene_of, versions, rays, pixels, samples, last_version):
    """The reference's answers: closest-hit distances and any-hit flags
    of ``rays``, and the frame at ``pixels`` in the last version's scene
    (``scene_of(version)`` gives the reference scene)."""
    out = {}
    for v in versions:
        sc = scene_of(v)
        for key, (ver, o, d, tm, _) in rays.items():
            m = ver == v
            if not m.any():
                continue
            args = [torch.from_numpy(x[m]).to(sc.device) for x in (o, d, tm)]
            if key[1] == "closest":
                val = sc.closest(*args)[0].float().cpu().numpy()
            else:
                val = sc.occluded(*args).cpu().numpy()
            res = out.setdefault(key, np.zeros(len(ver), val.dtype))
            res[m] = val
    sc = scene_of(last_version)
    for name, pix in pixels.items():
        frame = sc.frame(torch.from_numpy(pix).to(sc.device), samples)
        out[name] = frame.float().cpu().numpy()
    out["verts"] = sc.verts_np
    out["offsets"] = np.concatenate([[0], np.cumsum(np.bincount(
        sc.inst_of))])
    return out


def _mismatch(cand, ref, kind):
    """Per ray: whether the candidate's answer differs from the
    reference's."""
    if kind == "any":
        return cand.astype(bool) != ref.astype(bool)
    tc, tr = cand.astype(np.float64), ref.astype(np.float64)
    fc, fr = tc < 1e29, tr < 1e29
    gap = np.abs(tc - tr) > T_REL * np.maximum(np.abs(tr), 1.0)
    return (fc != fr) | (fc & gap)


def _l1(cand, ref):
    return float(np.abs(cand - ref).sum() / max(np.abs(ref).sum(), 1e-30))


def numbers(cand, ref, rays) -> dict:
    """The compared numbers of candidate answers ``cand`` against the
    reference's ``ref`` (both as ``answers`` gives them; ``verts`` in the
    reference's triangle order)."""
    out = {}
    for kind, name in (("closest", "closest_mismatch"),
                       ("any", "anyhit_mismatch")):
        if ("sample", kind) in rays:
            key = ("sample", kind)
            out[name] = float(np.mean(_mismatch(cand[key], ref[key], kind)))
    moved = [_mismatch(cand[k], ref[k], k[1]) for k in rays
             if k[0] == "moved"]
    if moved:
        out["moved_ray_mismatch"] = float(np.mean(np.concatenate(moved)))
    out["frame_l1"] = _l1(cand["frame"], ref["frame"])
    if "moved_frame" in cand:
        out["moved_frame_l1"] = _l1(cand["moved_frame"], ref["moved_frame"])
    if "verts" in cand:
        out["update_gap"] = float(np.abs(cand["verts"] - ref["verts"]).max())
    return out


def program_verts(tables, ref) -> np.ndarray:
    """The program's world vertices in the reference's triangle order,
    matched by its (instance, triangle) labels; a triangle it does not
    hold reads infinite."""
    idx = ref["offsets"][tables["tri_instance"].astype(np.int64)] \
        + tables["tri_prim"].astype(np.int64)
    out = np.full(ref["verts"].shape, np.inf, np.float32)
    out[idx] = tables["tri_vertices"]
    return out


def reference_scene(conf, layout, eye, state, device, dtype):
    moves = state.get("moves")
    cache = {}

    def scene_of(v):
        if v not in cache:
            cache.clear()
            cache[v] = tracer.Scene(
                conf, layout,
                translations_at(layout, moves, v) if moves else {}, eye,
                device, dtype, bn_cache=CACHE)
        return cache[v]
    return scene_of


def run(conf, mix, limits, layout, eye, state, cap, seed, device,
        control=False, log=None) -> dict:
    """{number: {"value", "limit"}} of the program's run; with
    ``control``, of the control's: the reference computed in bfloat16
    put in the program's place, against the float32 one."""
    versions, rays, pixels = plan(mix, cap.calls, state, conf, layout, eye,
                                  seed)
    last = len(state.get("moves", []))
    if log:
        log("# compared: " + ", ".join(
            [f"{g} {k} rays {len(r[0])}" for (g, k), r in rays.items()]
            + [f"{n} pixels {len(p)}" for n, p in pixels.items()]
            + [f"versions {versions}"]))

    def ref_answers(dtype):
        return answers(reference_scene(conf, layout, eye, state, device,
                                       dtype),
                       versions, rays, pixels, state["samples"], last)

    ref = ref_answers(torch.float32)
    if control:
        cand = ref_answers(torch.bfloat16)
        if "tables" not in state:
            cand.pop("verts")
    else:
        frame = np.asarray(state["frame"], np.float32).reshape(-1, 3)
        cand = {key: r[4] for key, r in rays.items()}
        cand.update({name: frame[pix] for name, pix in pixels.items()})
        if "tables" in state:
            cand["verts"] = program_verts(state["tables"], ref)
    got = numbers(cand, ref, rays)
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
