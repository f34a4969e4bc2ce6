"""Hit → ShadingData: attribute interpolation, texturing and shading
frames (torch port of ``rfw_tpu.ops.shade``).

Gathers the per-triangle attributes, interpolates them by barycentrics,
samples the texture atlases with the mip level from the ray-cone LOD
(lambda = triangle LOD + log2(cone width / |cos|)), applies normal maps
and alpha cutout, and assembles the BSDF parameter dict.

Barycentric convention: (u, v) weight vertices 1 and 2; w = 1-u-v
weights vertex 0.

Atlases: ``atlas`` is the flat (N, 4) float32 texel table with ``desc``
(T, L, 3) int32 rows (addr, width, height) per texture and mip level;
``matlas`` is the merged material atlas, (N, 3) RGBA8 words (diffuse,
normal, roughness/metal) carried as their int32 bit patterns
(``render.scene_data.scene_to_torch``). Wrapping is a floor modulo
(``torch.remainder``), as ``jnp.mod``. Seeds are int64 tensors holding
uint32 words (``ops.rng``).
"""

from __future__ import annotations

import torch

from . import fmath, rng
from .bsdf.common import safe_normalize
from .intersect import dot3

_MIN_ROUGHNESS_PARAM = 0.001

_PARAM_KEYS = ("metallic", "subsurface", "specular", "roughness",
               "specular_tint", "anisotropic", "sheen", "sheen_tint",
               "clearcoat", "clearcoat_gloss", "transmission", "eta")


def create_tangent_space(n):
    """Branchless orthonormal frame from a normal (Frisvad/Duff)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                     dim=-1)
    return t, bt


# ---------------------------------------------------------------------------
# Texture atlas sampling
# ---------------------------------------------------------------------------

def _wrap(i, n):
    """Repeat wrap of float texel coordinates ``i`` (whole numbers)."""
    return torch.remainder(i.to(torch.int32), torch.clamp(n, min=1))


def _texel_index(addr, width, yi, xi):
    return (addr + yi * width + xi).long()


def fetch_texel_bilinear(atlas, addr, width, height, uv):
    """Bilinear fetch with repeat wrap from the flat (N, 4) atlas.
    ``addr``/``width``/``height``: (R,) int32 mip descriptor; ``uv``:
    (R, 2)."""
    x = uv[..., 0] * width.float() - 0.5
    y = uv[..., 1] * height.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i, x1i = _wrap(x0, width), _wrap(x0 + 1, width)
    y0i, y1i = _wrap(y0, height), _wrap(y0 + 1, height)
    p00 = atlas[_texel_index(addr, width, y0i, x0i)]
    p10 = atlas[_texel_index(addr, width, y0i, x1i)]
    p01 = atlas[_texel_index(addr, width, y1i, x0i)]
    p11 = atlas[_texel_index(addr, width, y1i, x1i)]
    return ((1 - fy) * ((1 - fx) * p00 + fx * p10)
            + fy * ((1 - fx) * p01 + fx * p11))


def fetch_texel_nearest(atlas, addr, width, height, uv):
    """Point sample with repeat wrap (one tap)."""
    x = (uv[..., 0] * width.float()).to(torch.int32)
    y = (uv[..., 1] * height.float()).to(torch.int32)
    x = torch.remainder(x, torch.clamp(width, min=1))
    y = torch.remainder(y, torch.clamp(height, min=1))
    return atlas[_texel_index(addr, width, y, x)]


def _desc_at(desc, tex_id, level):
    """(addr, width, height) of each lane's texture and mip level."""
    d = desc[tex_id.long(), level.long()]
    return d[..., 0], d[..., 1], d[..., 2]


def fetch_texel_trilinear(atlas, desc, tex_id, uv, lam,
                          filter: str = "trilinear"):
    """Blend of two mip levels (8 taps); ``filter`` "bilinear" takes 4
    taps at the nearest level, "nearest" one. ``tex_id``: (R,) valid
    ids (callers mask unbound slots); ``lam``: (R,) LOD lambda."""
    levels = desc.shape[1]
    lam = torch.clamp(lam, 0.0, levels - 1)
    if filter == "trilinear":
        l0 = torch.floor(lam).to(torch.int32)
        l1 = torch.clamp(l0 + 1, max=levels - 1)
        f = (lam - l0.float())[..., None]
        p0 = fetch_texel_bilinear(atlas, *_desc_at(desc, tex_id, l0), uv)
        p1 = fetch_texel_bilinear(atlas, *_desc_at(desc, tex_id, l1), uv)
        return (1.0 - f) * p0 + f * p1
    if filter == "stochastic":
        raise ValueError("stochastic filter needs a seed — use "
                         "fetch_texel_stochastic")
    d0 = _desc_at(desc, tex_id, torch.round(lam).to(torch.int32))
    if filter == "bilinear":
        return fetch_texel_bilinear(atlas, *d0, uv)
    return fetch_texel_nearest(atlas, *d0, uv)


def _stochastic_texel(desc, tex_id, uv, lam, seed):
    """One tap of the stochastic trilinear estimator: the mip level and
    the bilinear corner are drawn with probability equal to their filter
    weights (3 draws from ``seed``), so the expectation is the 8-tap
    trilinear filter. Returns (texel index, new seed)."""
    levels = desc.shape[1]
    lam = torch.clamp(lam, 0.0, levels - 1)
    l0 = torch.floor(lam).to(torch.int32)
    f = lam - l0.float()
    seed, (r_mip, r_x, r_y) = rng.random_floats(seed, 3)
    lev = torch.where(r_mip < f, torch.clamp(l0 + 1, max=levels - 1), l0)
    addr, width, height = _desc_at(desc, tex_id, lev)
    x = uv[..., 0] * width.float() - 0.5
    y = uv[..., 1] * height.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = _wrap(torch.where(r_x < x - x0, x0 + 1, x0), width)
    yi = _wrap(torch.where(r_y < y - y0, y0 + 1, y0), height)
    return _texel_index(addr, width, yi, xi), seed


def fetch_texel_stochastic(atlas, desc, tex_id, uv, lam, seed):
    """One-tap stochastic trilinear fetch from the flat atlas. Returns
    (texel (R, 4), new seed)."""
    idx, seed = _stochastic_texel(desc, tex_id, uv, lam, seed)
    return atlas[idx], seed


def _unpack_rgba8(word):
    """(R,) RGBA8 words (int32 bit patterns, r in bits 0-7) → (R, 4)
    float32 in [0, 1]."""
    return torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF,
                        (word >> 24) & 0xFF], dim=-1).float() * (1.0 / 255.0)


def _unpack_row(px):
    return _unpack_rgba8(px[:, 0]), _unpack_rgba8(px[:, 1]), \
        _unpack_rgba8(px[:, 2])


def fetch_merged_stochastic(matlas, desc, eid, uv, lam, seed):
    """One merged-atlas row gather serving the diffuse, normal and
    roughness maps at once, with the stochastic trilinear estimator.
    Returns ((diffuse, normal, rough) each (R, 4), new seed)."""
    idx, seed = _stochastic_texel(desc, eid, uv, lam, seed)
    return _unpack_row(matlas[idx]), seed


def fetch_merged_trilinear(matlas, desc, eid, uv, lam):
    """Trilinear fetch from the merged material atlas: one row per corner
    serves all three maps (8 row gathers). Returns (diffuse, normal,
    rough), each (R, 4) float32 in [0, 1]."""
    levels = desc.shape[1]
    lam = torch.clamp(lam, 0.0, levels - 1)
    l0 = torch.floor(lam).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=levels - 1)
    lf = lam - l0.float()
    acc = [0.0, 0.0, 0.0]
    for lvl, lw in ((l0, 1.0 - lf), (l1, lf)):
        addr, width, height = _desc_at(desc, eid, lvl)
        x = uv[..., 0] * width.float() - 0.5
        y = uv[..., 1] * height.float() - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i, x1i = _wrap(x0, width), _wrap(x0 + 1, width)
        y0i, y1i = _wrap(y0, height), _wrap(y0 + 1, height)
        for xi, yi, cw in ((x0i, y0i, (1 - fx) * (1 - fy)),
                           (x1i, y0i, fx * (1 - fy)),
                           (x0i, y1i, (1 - fx) * fy),
                           (x1i, y1i, fx * fy)):
            maps = _unpack_row(matlas[_texel_index(addr, width, yi, xi)])
            w = (lw * cw)[..., None]
            for c in range(3):
                acc[c] = acc[c] + w * maps[c]
    return acc[0], acc[1], acc[2]


# ---------------------------------------------------------------------------
# ShadingData assembly
# ---------------------------------------------------------------------------

def _cone_lambda(desc, tex_id, cone_width, d, n_geom, lod_base):
    """Ray-cone LOD: log2(base width · cone width / |cos|) - triangle
    LOD."""
    base_w = desc[tex_id.long(), 0, 1].float()
    return fmath.log2(torch.clamp(
        base_w * cone_width
        / torch.clamp(dot3(-d, n_geom).abs(), min=1e-4), min=1e-20)) \
        - lod_base


def _uv_of(uvt, uv_i):
    return uvt[..., 0:2] * (uvt[..., 2:4] + uv_i)


def get_shading_data(scene, prim, u, v, d, cone_width, tex_flags=None,
                     tex_filter: str = "trilinear", stoch_seed=None):
    """Shading state for hit rays: (sd, n_geom, i_n, t_vec, b_vec,
    alpha_cut). ``prim`` indexes the permuted triangle planes (callers
    pass a valid index and mask misses themselves); ``d`` is the ray
    direction and ``cone_width`` the ray cone's width at the hit.
    ``tex_flags`` names the map kinds some material binds (None: the
    diffuse, normal and roughness maps); ``stoch_seed`` (R,) is the seed
    stream of ``tex_filter`` "stochastic", which without one falls back
    to "bilinear"."""
    if tex_filter == "stochastic" and stoch_seed is None:
        tex_filter = "bilinear"

    prim = torch.clamp(prim, min=0).long()
    row = scene["tri_pack"][prim]
    tri_n = row[:, 0:9].reshape(-1, 3, 3)
    n_geom = row[:, 15:18]
    mat_id = row[:, 24].long()

    w = (1.0 - u - v)[..., None]
    i_n = safe_normalize(w * tri_n[:, 0] + u[..., None] * tri_n[:, 1]
                         + v[..., None] * tri_n[:, 2])

    mats = scene["materials"]
    sd = {"color": mats["color"][mat_id],
          "absorption": mats["absorption"][mat_id],
          "flags": mats["flags"][mat_id]}
    for k in _PARAM_KEYS:
        sd[k] = mats[k][mat_id]
    sd["roughness"] = torch.clamp(sd["roughness"], min=_MIN_ROUGHNESS_PARAM)
    alpha_cut = torch.zeros_like(u, dtype=torch.bool)

    tf = tex_flags or {"diffuse": True, "normal": True, "rough": True}
    merged = scene.get("matlas") is not None and "mtex_id" in mats
    if any(tf.values()) and (merged or scene.get("atlas") is not None):
        tri_uv = row[:, 9:15].reshape(-1, 3, 2)
        uv_i = w * tri_uv[:, 0] + u[..., None] * tri_uv[:, 1] \
            + v[..., None] * tri_uv[:, 2]
        lod_base = row[:, 25]
        m_tex0 = mats["tex0_id"][mat_id]
        m_uvt = mats["tex0_uvtransform"][mat_id]
        has_tex0 = m_tex0 >= 0
        has_n = mats["tex1_id"][mat_id] >= 0
        m_alpha = mats["alpha_cutout"][mat_id].float() > 0.5

        def modulate(texel):
            sd["color"] = torch.where(has_tex0[..., None],
                                      sd["color"] * texel[..., :3],
                                      sd["color"])
            return has_tex0 & (texel[..., 3] < 0.5) & m_alpha

        if merged:
            # one fetch of the merged atlas serves all three maps
            matlas, desc = scene["matlas"], scene["matlas_desc"]
            eid = mats["mtex_id"][mat_id]
            uv0 = _uv_of(m_uvt, uv_i)
            lam = _cone_lambda(desc, eid, cone_width, d, n_geom, lod_base)
            if tex_filter == "stochastic":
                (texel, nm, mr), stoch_seed = fetch_merged_stochastic(
                    matlas, desc, eid, uv0, lam, stoch_seed ^ 0x2545F491)
            else:
                texel, nm, mr = fetch_merged_trilinear(matlas, desc, eid,
                                                       uv0, lam)
            if tf["diffuse"]:
                alpha_cut = modulate(texel)
            nm_vec = nm[..., :3] * 2.0 - 1.0
        else:
            # one flat-atlas fetch per map, each stochastic one from its
            # salted seed, in the reference's order
            atlas, desc = scene["atlas"], scene["atlas_desc"]

            def fetch(tid, uvq, lamq, salt):
                nonlocal stoch_seed
                tid = torch.clamp(tid, min=0)
                if tex_filter == "stochastic":
                    texel, stoch_seed = fetch_texel_stochastic(
                        atlas, desc, tid, uvq, lamq, stoch_seed ^ salt)
                    return texel
                return fetch_texel_trilinear(atlas, desc, tid, uvq, lamq,
                                             filter=tex_filter)

            def layers(slots, enabled):
                for slot, salt in slots:
                    tid = mats[f"tex{slot}_id"][mat_id]
                    uvl = _uv_of(mats[f"tex{slot}_uvtransform"][mat_id],
                                 uv_i)
                    yield (enabled & (tid >= 0))[..., None], \
                        fetch(tid, uvl, lam, salt)

            lam = torch.zeros_like(u)
            if tf["diffuse"]:
                lam = _cone_lambda(desc, torch.clamp(m_tex0, min=0),
                                   cone_width, d, n_geom, lod_base)
                alpha_cut = modulate(fetch(m_tex0, _uv_of(m_uvt, uv_i), lam,
                                           0x68E31DA4))
                if tf.get("diffuse_layers") and "tex5_id" in mats:
                    # the 2nd and 3rd diffuse layers add to the modulated
                    # base (the reference CUDA code then multiplies by the
                    # base texel again; rfw_tpu does not copy that)
                    for on, texl in layers(((5, 0x41C64E6D),
                                            (6, 0x6C078965)), has_tex0):
                        sd["color"] = torch.where(
                            on, sd["color"] + texl[..., :3], sd["color"])
            if tf["rough"]:
                mr = fetch(mats["tex3_id"][mat_id], uv_i, lam, 0xB5297A4D)
            if tf["normal"]:
                nm_vec = fetch(mats["tex1_id"][mat_id], uv_i, lam,
                               0x1B56C4E9)[..., :3] * 2.0 - 1.0
                if tf.get("normal_layers") and "tex7_id" in mats:
                    # the 2nd and 3rd normal layers add tangent-space
                    # vectors before the normalize, each read from its
                    # own slot (the reference CUDA code reads layer 1's
                    # address for layer 2; rfw_tpu does not copy that)
                    for on, nml in layers(((7, 0x9908B0DF),
                                           (8, 0x3243F6A8)), has_n):
                        nm_vec = torch.where(
                            on, nm_vec + (nml[..., :3] * 2.0 - 1.0), nm_vec)
        if tf["rough"]:
            # glTF metallicRoughness: G = roughness, B = metalness
            has_r = mats["tex3_id"][mat_id] >= 0
            sd["roughness"] = torch.where(
                has_r, torch.clamp(sd["roughness"] * mr[..., 1],
                                   min=_MIN_ROUGHNESS_PARAM),
                sd["roughness"])
            sd["metallic"] = torch.where(has_r, sd["metallic"] * mr[..., 2],
                                         sd["metallic"])
        if tf["normal"]:
            # tangent-space normal map in the triangle's UV-aligned frame
            mapped = safe_normalize(nm_vec[..., 0:1] * row[:, 18:21]
                                    + nm_vec[..., 1:2] * row[:, 21:24]
                                    + nm_vec[..., 2:3] * i_n)
            i_n = torch.where(has_n[..., None], mapped, i_n)

    t_vec, b_vec = create_tangent_space(i_n)
    return sd, n_geom, i_n, t_vec, b_vec, alpha_cut
