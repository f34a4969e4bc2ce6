"""The plain reference of what the benchmark checks: ray/triangle answers
(closest hit, any hit) by brute force over each bounding sphere's
triangles, and the renderer's path for chosen pixels and samples, with
the same random numbers, lights, sky, BSDF and settings.

It is built from the benchmark's own data (the layout of
``lib.geometry``) and the configuration (its materials, lamps, sky,
camera and settings), in plain torch, and takes nothing the program
made: no triangle tables, lights, sky tables or blue-noise mask. It
imports neither the program nor JAX. ``dtype`` sets the precision of
every quantity it computes (float32; the control takes bfloat16);
culling by bounding sphere runs in float64 with a margin and decides no
answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lib import geometry
from . import bsdf, rng

BIG_T = 1e30

# the renderer's settings the reference follows: the program's defaults,
# which the configuration files state under "render" and may override
SETTINGS = {"max_path_length": 2, "min_roughness": 0.01,
            "firefly_clamp": 10.0, "geometry_epsilon": 1e-5,
            "t_epsilon": 1e-4, "env_nee_interleave": 256,
            "envmap_nee_max_depth": 0, "blue_noise_spp_cutoff": 256}
MATERIAL_DEFAULTS = {"metallic": 0.0, "subsurface": 0.0, "specular": 0.5,
                     "roughness": 0.5, "specular_tint": 0.0,
                     "anisotropic": 0.0, "sheen": 0.0, "sheen_tint": 0.0,
                     "clearcoat": 0.0, "clearcoat_gloss": 1.0,
                     "transmission": 0.0, "eta": 1.0}
# settings that change how the program schedules the work, not the image:
# chunks of lanes, and row-block tiles over several cards, whose frame
# equals the one-card frame because every random draw is keyed by the
# absolute pixel id
SCHEDULE_ONLY = ("max_rays_per_pass", "n_devices")
MIN_ROUGHNESS_PARAM = 0.001
RAY_CHUNK_ELEMS = 1 << 24      # rays x triangles of one brute-force pass


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=1e-20))[..., None]


def _f64(fn, *xs):
    return fn(*(x.double() for x in xs)).to(xs[0].dtype)


# ---------------------------------------------------------------------------
# sky and camera
# ---------------------------------------------------------------------------

def sky_tables(pixels: np.ndarray) -> dict:
    """The luminance-weighted flat CDF and solid-angle pdf of the sky."""
    lum = (pixels * np.array([0.2126, 0.7152, 0.0722], np.float32)).sum(-1)
    h, w = lum.shape
    sin_theta = np.sin((np.arange(h, dtype=np.float32) + 0.5) / h * np.pi)
    weighted = (lum * sin_theta[:, None]).astype(np.float64) + 1e-12
    cdf = np.cumsum(weighted.reshape(-1))
    total = cdf[-1]
    pdf = (weighted / total * (w * h) / (2.0 * np.pi * np.pi * np.maximum(
        sin_theta[:, None], 1e-6))).astype(np.float32)
    return {"flat_cdf": (cdf / total).astype(np.float32), "pdf": pdf}


def camera_view(cam: dict, eye, width: int, height: int) -> dict:
    """The image plane of the configuration's camera ``cam`` at ``eye``
    (float32 numpy): pos, p1 (top left), p2 (top right), p3 (bottom
    left), aperture."""
    origin = np.asarray(eye, np.float32)
    d = np.asarray(cam["target"], np.float32) - origin
    z = (d / np.linalg.norm(d)).astype(np.float32)    # as look_at keeps it
    z = (z / np.linalg.norm(z)).astype(np.float32)
    y = np.array([0.0, 1.0, 0.0], np.float32)
    x = np.cross(z, y)
    x = (x / np.linalg.norm(x)).astype(np.float32)
    y = np.cross(x, z).astype(np.float32)
    screen = math.tan(math.radians(cam["fov"]) / 2.0)
    focal = cam["focal_distance"]
    aspect = float(width) / float(height)
    center = origin + focal * z
    sr = screen * focal * aspect * x
    su = screen * focal * y
    return {"pos": origin, "p1": (center - sr + su).astype(np.float32),
            "p2": (center + sr + su).astype(np.float32),
            "p3": (center - sr - su).astype(np.float32),
            "aperture": np.float32(cam["aperture"])}


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

class Scene:
    """The reference's scene on ``device`` in ``dtype``: the world
    triangles of ``geometry.world_instances`` grouped by bounding sphere
    (each instance's ``group`` consecutive triangles a group; an instance
    without one is tested by every ray), their shading attributes and
    materials, the area lights (the triangles of emissive materials, any
    colour channel above 1, in triangle order), the sky and its tables,
    the blue-noise stack and the camera view, all from the
    configuration ``conf`` and its ``layout``."""

    def __init__(self, conf, layout, translations, eye, device,
                 dtype=torch.float32, bn_cache: str | None = None):
        self.device, self.dtype = torch.device(device), dtype
        self.width, self.height = conf["width"], conf["height"]
        settings = conf["render"]
        unknown = set(settings) - set(SETTINGS) - set(SCHEDULE_ONLY)
        if unknown:
            raise ValueError(f"the reference does not follow {sorted(unknown)}")
        self.settings = {**SETTINGS, **settings}
        world = geometry.world_instances(layout, translations)
        # the global triangle order: instances in the order they are added
        verts = np.concatenate([w["verts"] for w in world])
        self.inst_of = np.concatenate([np.full(len(w["verts"]), i, np.int32)
                                       for i, w in enumerate(world)])
        if dtype != torch.float32:
            verts = self._world_verts(layout, translations, world)
        self.verts_np = verts
        groups, start = [], 0
        for inst, w in zip(layout, world):
            n = len(w["verts"])
            bounded = inst["group"] is not None
            step = inst["group"] if bounded else n
            for s in range(0, n, step):
                v = w["verts"][s:s + step].reshape(-1, 3).astype(np.float64)
                c = 0.5 * (v.min(0) + v.max(0))
                r = np.sqrt(((v - c) ** 2).sum(-1).max()) * (1 + 1e-3) + 1e-3
                groups.append((start + s, start + s + min(step, n - s),
                               c if bounded else None, r))
            start += n
        self.groups = groups
        cen = [g[2] for g in groups if g[2] is not None]
        self.centers = torch.tensor(np.array(cen), dtype=torch.float64,
                                    device=self.device) if cen else None
        self.radii = torch.tensor([g[3] for g in groups if g[2] is not None],
                                  dtype=torch.float64, device=self.device)
        dev, dt = self.device, dtype
        v = torch.from_numpy(verts).to(dev, dt)
        self.v0 = v[:, 0]
        self.e1 = v[:, 1] - v[:, 0]
        self.e2 = v[:, 2] - v[:, 0]
        self.normals = torch.from_numpy(
            np.concatenate([w["normals"] for w in world])).to(dev, dt)
        self.gnormal = torch.from_numpy(
            np.concatenate([w["gnormal"] for w in world])).to(dev, dt)
        self.area = torch.from_numpy(
            np.concatenate([w["area"] for w in world])).to(dev, dt)
        names = list(conf["materials"])
        mat_np = np.concatenate([np.full(len(w["verts"]),
                                         names.index(w["material"]), np.int64)
                                 for w in world])
        self.mat = torch.from_numpy(mat_np).to(dev)
        self.materials = {}
        rows = [{**MATERIAL_DEFAULTS, **conf["materials"][k]} for k in names]
        self.materials["color"] = torch.tensor(
            [r["color"] for r in rows], dtype=torch.float32).to(dev, dt)
        self.materials["absorption"] = torch.zeros((len(rows), 3),
                                                   device=dev, dtype=dt)
        for k in MATERIAL_DEFAULTS:
            self.materials[k] = torch.tensor(
                [r[k] for r in rows], dtype=torch.float32).to(dev, dt)
        # the emissive triangles are the area lights, in triangle order
        emissive = np.array([np.any(np.asarray(r["color"]) > 1.0)
                             for r in rows])
        lamp = np.nonzero(emissive[mat_np])[0]
        light_idx = np.full(len(mat_np), -1, np.int64)
        light_idx[lamp] = np.arange(len(lamp))
        self.light_idx = torch.from_numpy(light_idx).to(dev)
        lv = torch.from_numpy(verts[lamp]).to(dev)
        self.lights = {
            "v0": lv[:, 0].to(dt), "v1": lv[:, 1].to(dt),
            "v2": lv[:, 2].to(dt),
            "normal": self.gnormal[torch.from_numpy(lamp).to(dev)],
            "radiance": self.materials["color"][
                torch.from_numpy(mat_np[lamp]).to(dev)],
            "position": ((lv[:, 0] + lv[:, 1] + lv[:, 2]) / 3.0).to(dt),
            "area": self.area[torch.from_numpy(lamp).to(dev)],
            "energy": torch.linalg.vector_norm(
                self.materials["color"][torch.from_numpy(mat_np[lamp]).to(
                    dev)].float(), dim=-1).to(dt)}
        pixels = geometry.sky_pixels(conf["sky"])
        tables = sky_tables(pixels)
        self.sky = torch.from_numpy(pixels).to(dev, dt)
        self.sky_pdf = torch.from_numpy(tables["pdf"]).to(dev, dt)
        self.sky_cdf = torch.from_numpy(tables["flat_cdf"]).to(dev, dt)
        self.bn = torch.from_numpy(rng.blue_noise_stack(
            rng.blue_noise_mask(bn_cache))).to(dev)
        self.view = {k: torch.as_tensor(np.asarray(x, np.float32)).to(dev, dt)
                     for k, x in camera_view(conf["camera"], eye, self.width,
                                             self.height).items()}

    def _world_verts(self, layout, translations, world) -> np.ndarray:
        """The world vertices computed in ``self.dtype`` (scale, then
        translation, each product and sum rounded to it), as float32."""
        out = []
        for i, (inst, w) in enumerate(zip(layout, world)):
            v = torch.from_numpy(inst["pos"][inst["faces"]]).to(self.dtype)
            if inst["scale"] is not None:
                tr = translations.get(i, inst["translation"])
                v = v * torch.from_numpy(np.asarray(inst["scale"], np.float32)
                                         ).to(self.dtype) \
                    + torch.from_numpy(np.asarray(tr, np.float32)
                                       ).to(self.dtype)
            out.append(v.float().numpy())
        return np.concatenate(out)

    def _full(self, like, value):
        return torch.full(like.shape, value, dtype=self.dtype,
                          device=self.device)

    # -- intersection ------------------------------------------------------

    def _candidates(self, o, d, t_max):
        """(R, G) bool: the ray's segment meets the group's bounding
        sphere (always true for unbounded groups)."""
        n = o.shape[0]
        out = torch.ones((n, len(self.groups)), dtype=torch.bool,
                         device=self.device)
        if self.centers is None:
            return out
        o64, d64 = o.double(), d.double()
        oc = o64[:, None, :] - self.centers[None]
        dd = (d64 * d64).sum(-1)[:, None]
        b = (oc * d64[:, None, :]).sum(-1)
        cc = (oc * oc).sum(-1) - self.radii[None] ** 2
        disc = b * b - dd * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        near = (-b - sq) / dd
        far = (-b + sq) / dd
        hit = (disc >= 0) & (far > 0) & (near < t_max.double()[:, None])
        bounded = [i for i, g in enumerate(self.groups) if g[2] is not None]
        out[:, bounded] = hit
        return out

    def _test(self, o, d, lo: int, hi: int, t_max):
        """Möller-Trumbore of rays (n, 3) against triangles lo:hi: (hit,
        t, u, v), each (n, hi - lo)."""
        o, d = o[:, None, :], d[:, None, :]
        v0, e1, e2 = self.v0[None, lo:hi], self.e1[None, lo:hi], \
            self.e2[None, lo:hi]
        pvec = cross3(d, e2)
        det = dot3(e1, pvec)
        valid = det.abs() > 1e-12
        inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
        tvec = o - v0
        u = dot3(tvec, pvec) * inv_det
        qvec = cross3(tvec, e1)
        v = dot3(d, qvec) * inv_det
        t = dot3(e2, qvec) * inv_det
        hit = (valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > self.settings["t_epsilon"]) & (t < t_max[:, None]))
        return hit, t, u, v

    def _walk(self, o, d, t_max, any_hit: bool):
        n = o.shape[0]
        t_best = self._full(t_max, BIG_T)
        prim = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        ub, vb = self._full(t_max, 0.0), self._full(t_max, 0.0)
        hit_any = torch.zeros(n, dtype=torch.bool, device=self.device)
        cand = self._candidates(o, d, t_max)
        for g, (lo, hi, _, _) in enumerate(self.groups):
            idx = torch.nonzero(cand[:, g]).flatten()
            step = max(1, RAY_CHUNK_ELEMS // (hi - lo))
            for s in range(0, idx.numel(), step):
                rows = idx[s:s + step]
                bound = t_max[rows] if any_hit else torch.minimum(
                    t_max[rows], t_best[rows])
                hit, t, u, v = self._test(o[rows], d[rows], lo, hi, bound)
                if any_hit:
                    hit_any[rows] |= hit.any(-1)
                    continue
                t = torch.where(hit, t, BIG_T)
                tk, k = torch.min(t, dim=-1)
                better = tk < t_best[rows]
                ar = torch.arange(rows.numel(), device=self.device)
                t_best[rows] = torch.where(better, tk, t_best[rows])
                prim[rows] = torch.where(better, k + lo, prim[rows])
                ub[rows] = torch.where(better, u[ar, k], ub[rows])
                vb[rows] = torch.where(better, v[ar, k], vb[rows])
        if any_hit:
            return hit_any
        return t_best, prim, ub, vb

    def closest(self, o, d, t_max):
        """(t, prim, u, v): t = 1e30 and prim = -1 where nothing is hit
        below ``t_max``; prim in the global triangle order."""
        return self._walk(o.to(self.dtype), d.to(self.dtype),
                          t_max.to(self.dtype), any_hit=False)

    def occluded(self, o, d, dist):
        """Whether a triangle lies between t_epsilon and ``dist``."""
        return self._walk(o.to(self.dtype), d.to(self.dtype),
                          dist.to(self.dtype), any_hit=True)

    # -- lights and sky ----------------------------------------------------

    def _potentials(self, i_pt, n, bary=None):
        """(R, L) potentials of the area lights, as the light picker
        weighs them."""
        li = self.lights
        if bary is None:
            p = li["position"][None]
        else:
            p = (bary[:, None, 0:1] * li["v0"][None]
                 + bary[:, None, 1:2] * li["v1"][None]
                 + bary[:, None, 2:3] * li["v2"][None])
        l_vec = p - i_pt[:, None, :]
        att = 1.0 / torch.clamp(dot3(l_vec, l_vec), min=1e-12)
        l_dir = bsdf.safe_normalize(l_vec)
        ln_dot_l = torch.clamp(-dot3(li["normal"][None], l_dir), min=0.0)
        n_dot_l = torch.clamp(dot3(n[:, None, :], l_dir), min=0.0)
        return li["energy"][None] * ln_dot_l * n_dot_l * att

    @staticmethod
    def _prefix(pot):
        cols = [pot[:, 0]]
        for j in range(1, pot.shape[1]):
            cols.append(cols[-1] + pot[:, j])
        return torch.stack(cols, dim=1)

    def pick_prob(self, light_idx, i_pt, n):
        pot = self._potentials(i_pt, n)
        s = self._prefix(pot)[:, -1]
        idx = torch.clamp(light_idx, 0, pot.shape[1] - 1)
        picked = torch.gather(pot, 1, idx[:, None])[:, 0]
        return torch.where(s > 0, picked / torch.clamp(s, min=1e-30), 0.0)

    @staticmethod
    def random_barycentrics(r0):
        uf = torch.clamp((r0.float() * 4294967296.0).long(), max=0xFFFFFFFF)
        one, zero = torch.ones_like(r0), torch.zeros_like(r0)
        ax, ay, bx, by, cx, cy = one, zero, zero, one, zero, zero
        for i in range(16):
            d = (uf >> (2 * (15 - i))) & 3
            d0, d1, d2 = d == 0, d == 1, d == 2

            def pick(c0, c1, c2, c3):
                return torch.where(d0, c0, torch.where(
                    d1, c1, torch.where(d2, c2, c3)))

            anx = pick((bx + cx) * 0.5, ax, (bx + ax) * 0.5, (cx + ax) * 0.5)
            any_ = pick((by + cy) * 0.5, ay, (by + ay) * 0.5, (cy + ay) * 0.5)
            bnx = pick((ax + cx) * 0.5, (ax + bx) * 0.5, bx, (cx + bx) * 0.5)
            bny = pick((ay + cy) * 0.5, (ay + by) * 0.5, by, (cy + by) * 0.5)
            cnx = pick((ax + bx) * 0.5, (ax + cx) * 0.5, (bx + cx) * 0.5, cx)
            cny = pick((ay + by) * 0.5, (ay + cy) * 0.5, (by + cy) * 0.5, cy)
            ax, ay, bx, by, cx, cy = anx, any_, bnx, bny, cnx, cny
        rx = (ax + bx + cx) * (1.0 / 3.0)
        ry = (ay + by + cy) * (1.0 / 3.0)
        return torch.stack([rx, ry, 1.0 - rx - ry], dim=-1)

    def point_on_light(self, r0, r1, i_pt, n):
        """The potential-weighted pick of an area light and a point on it:
        (position, pick_prob, light_pdf, radiance)."""
        li = self.lights
        bary = self.random_barycentrics(r0)
        pot = self._potentials(i_pt, n, bary)
        cdf = self._prefix(pot)
        s = cdf[:, -1]
        idx = torch.clamp((cdf < (r1 * s)[:, None]).sum(1), 0,
                          pot.shape[1] - 1)
        pick = torch.gather(pot, 1, idx[:, None])[:, 0] \
            / torch.clamp(s, min=1e-30)
        no_light = s <= 0.0
        p = (bary[:, 0:1] * li["v0"][idx] + bary[:, 1:2] * li["v1"][idx]
             + bary[:, 2:3] * li["v2"][idx])
        l_vec = i_pt - p
        sq_dist = dot3(l_vec, l_vec)
        l_dir = bsdf.safe_normalize(l_vec)
        ln_dot_l = dot3(l_dir, li["normal"][idx])
        reci = sq_dist / torch.clamp(li["area"][idx] * ln_dot_l, min=1e-30)
        pdf = torch.where((ln_dot_l > 0) & (dot3(l_dir, n) < 0), reci, 0.0)
        return (torch.where(no_light[..., None], i_pt + 1.0, p),
                torch.where(no_light, 0.0, pick),
                torch.where(no_light, 0.0, pdf), li["radiance"][idx])

    def _sky_texel(self, d):
        h, w = self.sky.shape[0], self.sky.shape[1]
        u = (w * 0.5 * (1.0 + _f64(torch.atan2, d[..., 0], -d[..., 2])
                        * (1.0 / math.pi))).to(torch.int32)
        v = (h * (_f64(torch.arccos, torch.clamp(d[..., 1], -1.0, 1.0))
                  * (1.0 / math.pi))).to(torch.int32)
        return (torch.clamp(u, 0, w - 1).long(),
                torch.clamp(v, 0, h - 1).long())

    def sky_radiance(self, d):
        x, y = self._sky_texel(d)
        return self.sky[y, x], self.sky_pdf[y, x]

    def sample_sky(self, r):
        h, w = self.sky.shape[0], self.sky.shape[1]
        idx = torch.clamp(torch.searchsorted(self.sky_cdf, r.contiguous()),
                          0, h * w - 1)
        y, x = idx // w, idx % w
        u = (x.to(self.dtype) + 0.5) / w
        v = (y.to(self.dtype) + 0.5) / h
        phi = (2.0 * u - 1.0) * math.pi
        theta = v * math.pi
        sin_t = _f64(torch.sin, theta)
        d = torch.stack([sin_t * _f64(torch.sin, phi), _f64(torch.cos, theta),
                         -sin_t * _f64(torch.cos, phi)], dim=-1)
        return d, self.sky_pdf[y, x], self.sky[y, x]

    # -- shading -----------------------------------------------------------

    def shading(self, prim, u, v):
        """(sd, n_geom, i_n, t_vec, b_vec) of hits on ``prim``."""
        tri_n = self.normals[prim]
        w = (1.0 - u - v)[..., None]
        i_n = bsdf.safe_normalize(w * tri_n[:, 0] + u[..., None] * tri_n[:, 1]
                                  + v[..., None] * tri_n[:, 2])
        m = self.mat[prim]
        sd = {k: self.materials[k][m] for k in
              ("color", "absorption", *MATERIAL_DEFAULTS)}
        sd["roughness"] = torch.clamp(sd["roughness"],
                                      min=MIN_ROUGHNESS_PARAM)
        n = i_n
        sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + n[..., 2])
        b = n[..., 0] * n[..., 1] * a
        t_vec = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a,
                             sign * b, -sign * n[..., 0]], dim=-1)
        b_vec = torch.stack([b, sign + n[..., 1] * n[..., 1] * a,
                             -n[..., 1]], dim=-1)
        return sd, self.gnormal[prim], i_n, t_vec, b_vec

    # -- the path ----------------------------------------------------------

    def primary(self, pid, sidx):
        """Primary rays of pixels ``pid`` at samples ``sidx``."""
        w, h = self.width, self.height
        sx, sy = pid % w, pid // w
        r0, r1, r2, r3 = (rng.blue_noise(self.bn, sx, sy, sidx, k, self.dtype)
                          for k in range(4))
        blade = torch.floor(r0 * 9.0)
        r2 = (r2 - blade * (1.0 / 9.0)) * 9.0
        a1 = blade * (math.pi / 4.5)
        a2 = (blade + 1.0) * (math.pi / 4.5)
        x1, y1 = _f64(torch.sin, a1), _f64(torch.cos, a1)
        x2, y2 = _f64(torch.sin, a2), _f64(torch.cos, a2)
        flip = (r2 + r3) > 1.0
        r2 = torch.where(flip, 1.0 - r2, r2)
        r3 = torch.where(flip, 1.0 - r3, r3)
        xr, yr = x1 * r2 + x2 * r3, y1 * r2 + y2 * r3
        vw = self.view
        right, up = vw["p2"] - vw["p1"], vw["p3"] - vw["p1"]
        origin = vw["pos"][None, :] + vw["aperture"] * (
            right[None, :] * xr[:, None] + up[None, :] * yr[:, None])
        uu = (sx.to(self.dtype) + r0) * (1.0 / w)
        vv = (sy.to(self.dtype) + r1) * (1.0 / h)
        point = vw["p1"][None, :] + uu[:, None] * right[None, :] \
            + vv[:, None] * up[None, :]
        return origin, normalize(point - origin)

    def trace(self, pid, sidx):
        """The radiance (L, 3) of one path per lane: pixel ``pid``, sample
        ``sidx`` (int64 tensors), every depth of the renderer's loop."""
        cfg = self.settings
        dt, dev = self.dtype, self.device
        n = pid.shape[0]
        px, py = pid % self.width, pid // self.width
        origin, direction = self.primary(pid, sidx)
        throughput = torch.ones((n, 3), dtype=dt, device=dev)
        radiance = torch.zeros((n, 3), dtype=dt, device=dev)
        last_pdf = torch.ones(n, dtype=dt, device=dev)
        spec_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
        last_n = direction
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        clamp_v = float(cfg["firefly_clamp"])

        def add(mask, value):
            value = torch.where(torch.isnan(value), 0.0, value)
            return torch.where(mask[..., None],
                               bsdf.clamp_intensity(value, clamp_v), 0.0)

        def env_ok(dep):
            m = cfg["envmap_nee_max_depth"]
            return m < 0 or dep <= m

        for depth in range(cfg["max_path_length"] + 1):
            t_max = torch.where(alive, self._full(last_pdf, BIG_T),
                                self._full(last_pdf, 0.0))
            t, prim, u, v = self.closest(origin, direction, t_max)
            prim = torch.where(alive, prim, -1)
            miss = prim < 0
            sky, e_pdf_m = self.sky_radiance(direction)
            if depth > 0 and env_ok(depth - 1):
                denom_m = torch.where(spec_bounce, last_pdf,
                                      last_pdf + e_pdf_m)
            else:
                denom_m = last_pdf
            contrib = throughput * sky \
                / torch.clamp(denom_m, min=1e-20)[..., None]
            radiance = radiance + add(alive & miss, contrib)
            alive = alive & ~miss
            ps = torch.clamp(prim, min=0)
            hit_pos = origin + direction * t[..., None]
            sd, n_geom, i_n, t_vec, b_vec = self.shading(ps, u, v)

            emissive = (sd["color"] > 1.0).any(-1)
            d_dot_nl = -dot3(direction, n_geom)
            if depth == 0:
                e_contrib = sd["color"]
            else:
                light_pdf = (t * t) / torch.where(
                    -dot3(direction, n_geom) * self.area[ps] != 0,
                    -dot3(direction, n_geom) * self.area[ps], 1.0)
                pick = self.pick_prob(self.light_idx[ps], origin, last_n)
                denom = last_pdf + light_pdf * pick
                mis_c = throughput * sd["color"] \
                    / torch.clamp(denom, min=1e-20)[..., None]
                mis_c = torch.where((denom > 0)[..., None], mis_c, 0.0)
                spec_c = throughput * sd["color"] \
                    / torch.clamp(last_pdf, min=1e-20)[..., None]
                e_contrib = torch.where(spec_bounce[..., None], spec_c, mis_c)
            e_contrib = torch.where((d_dot_nl > 0)[..., None], e_contrib, 0.0)
            radiance = radiance + add(alive & emissive, e_contrib)
            alive = alive & ~emissive

            flip = torch.where(dot3(direction, n_geom) > 0, -1.0, 1.0)
            n_geom = n_geom * flip[..., None]
            i_n = i_n * flip[..., None]
            backfacing = flip < 0
            throughput = throughput / torch.clamp(last_pdf, min=1e-20)[..., None]
            spec_mat = sd["roughness"] < cfg["min_roughness"]
            seed = rng.wang_hash(rng.path_seed(pid, sidx, depth) ^ 0x9E3779B9)
            d0, d1 = 4 + 2 * depth, 5 + 2 * depth
            r0 = rng.blue_noise(self.bn, px, py, sidx, d0, dt)
            r1 = rng.blue_noise(self.bn, px, py, sidx, d1, dt)
            seed, (h0, h1) = rng.random_floats(seed, 2, dt)
            late = sidx >= cfg["blue_noise_spp_cutoff"]
            r0, r1 = torch.where(late, h0, r0), torch.where(late, h1, r1)
            l_pos, l_pick, l_pdf, l_rad = self.point_on_light(r0, r1, hit_pos,
                                                              i_n)
            l_vec = l_pos - hit_pos
            dist = torch.sqrt(torch.clamp(dot3(l_vec, l_vec), min=1e-20))
            l_dir = l_vec / dist[..., None]
            n_dot_l = dot3(l_dir, i_n)
            s_val, s_pdf = bsdf.evaluate_bsdf(sd, i_n, t_vec, b_vec,
                                              -direction, l_dir)
            denom = s_pdf + l_pdf * l_pick
            nee = throughput * s_val * l_rad \
                * (n_dot_l / torch.clamp(denom, min=1e-20))[..., None]
            want = (alive & ~spec_mat & (n_dot_l > 0) & (l_pdf > 0)
                    & (s_pdf > 0))
            s_origin = hit_pos + n_geom * 1e-5
            s_dist = torch.where(want, dist - 2.0 * cfg["geometry_epsilon"],
                                 0.0)
            if env_ok(depth):
                tb = max(int(round(cfg["env_nee_interleave"] ** 0.5)), 1)
                tiles_x = (self.width + tb - 1) // tb
                gid = (py // tb) * tiles_x + px // tb
                _, re = rng.random_float(rng.wang_hash(
                    rng.path_seed(gid, sidx, depth) ^ 0x517CC1B7), dt)
                e_dir, e_pdf, e_rad = self.sample_sky(re)
                e_cos = dot3(e_dir, i_n)
                eb_val, eb_pdf = bsdf.evaluate_bsdf(sd, i_n, t_vec, b_vec,
                                                    -direction, e_dir)
                e_c = throughput * eb_val * e_rad \
                    * (e_cos / torch.clamp(e_pdf + eb_pdf, min=1e-20))[..., None]
                e_want = (alive & ~spec_mat & (e_cos > 0) & (e_pdf > 0)
                          & (eb_pdf > 0))
                occ2 = self.occluded(
                    torch.cat([s_origin, s_origin]), torch.cat([l_dir, e_dir]),
                    torch.cat([s_dist, torch.where(e_want, BIG_T, 0.0)]))
                occ, e_occ = occ2[:n], occ2[n:]
                radiance = radiance + add(want & ~occ, nee)
                radiance = radiance + add(e_want & ~e_occ, e_c)
            else:
                occ = self.occluded(s_origin, l_dir, s_dist)
                radiance = radiance + add(want & ~occ, nee)
            if depth >= cfg["max_path_length"]:
                break
            seed, (r3, r4) = rng.random_floats(seed, 2, dt)
            b_val, wi, new_pdf, _ = bsdf.sample_bsdf(
                sd, i_n, n_geom, t_vec, b_vec, -direction, t, backfacing,
                r3, r4)
            new_tp = throughput * b_val * dot3(i_n, wi).abs()[..., None]
            survival = torch.clamp(bsdf.survival_probability(throughput),
                                   1e-6, 1.0)
            seed, rr = rng.random_float(seed, dt)
            alive = alive & (rr <= survival)
            new_tp = new_tp / survival[..., None]
            valid = ((new_pdf > 1e-6) & ~torch.isnan(new_pdf)
                     & (new_tp >= 0.0).all(-1) & ~torch.isnan(new_tp).any(-1))
            alive = alive & valid
            throughput, last_pdf = new_tp, new_pdf
            spec_bounce, last_n = spec_mat, i_n
            origin = hit_pos + n_geom * 1e-5
            direction = wi
        return radiance

    def frame(self, pixels, samples: int, lanes: int = 1 << 16):
        """The accumulated frame (P, 3) of ``pixels`` (int64 tensor) over
        samples 0 .. ``samples`` - 1: each sample's radiance added in
        sample order, over the sample count."""
        acc = torch.zeros((pixels.shape[0], 3), dtype=self.dtype,
                          device=self.device)
        per = max(1, lanes // max(pixels.shape[0], 1))
        for s0 in range(0, samples, per):
            ss = torch.arange(s0, min(samples, s0 + per), device=self.device)
            pid = pixels.repeat(ss.numel())
            sidx = ss.repeat_interleave(pixels.shape[0])
            rad = self.trace(pid, sidx).reshape(ss.numel(), -1, 3)
            for k in range(ss.numel()):
                acc = acc + rad[k]
        return acc / float(max(samples, 1))
