"""Texture fetches and textured shading of the port against rfw_tpu.

Both sides read the same atlases (built by rfw_tpu's numpy host code from
seeded images) at the same seeded texel coordinates, LOD lambdas and
seeds. The stochastic fetches take the same texels bit for bit; the
filtered ones agree to 1e-6 (the same float32 formulas); full shading
agrees to 1e-5 (``log2`` of the ray-cone LOD and the normalisations round
a few ulps apart). The merged atlas crosses ``scene_to_torch`` as its
int32 bit pattern."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.ops import shade as jshade
from rfw_tpu.render import scene_data as jax_sd
from rfw_tpu.scene import HostMaterial as JHostMaterial
from rfw_tpu.scene import Texture as JTexture
from rfw_tpu.scene import texture as j_texture
from rfw_tpu.system import RenderSystem as JRenderSystem

from rfw_tpu_torch.ops import shade as tshade
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.scene import texture

R = 2048
FETCH_TOL = dict(rtol=1e-6, atol=1e-6)
SHADE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_texture_cache(monkeypatch):
    monkeypatch.setenv("RFW_NO_TEX_CACHE", "1")


def _images(rng):
    """Seeded RGBA images of even and odd sizes, alpha spread over
    [0, 1] so that cutout and the RGBA8 sign bit are both exercised."""
    return [rng.random((h, w, 4), dtype=np.float32)
            for h, w in ((32, 32), (16, 64), (64, 48), (8, 8))]


@pytest.fixture(scope="module")
def atlases():
    """rfw_tpu's flat atlas of four seeded textures and the merged atlas
    of three materials over them."""
    rng = np.random.default_rng(41)
    texs = [JTexture.from_array(img) for img in _images(rng)]
    mats = []
    for t0, t1, t3 in ((0, 1, 2), (3, -1, 0), (-1, 2, -1)):
        m = JHostMaterial()
        for slot, tid in ((0, t0), (1, t1), (3, t3)):
            m.maps[slot].texture_id = tid
        mats.append(m)
    flat = j_texture.build_texture_atlas(texs)
    merged, mtex_id = j_texture.build_merged_material_atlas(mats, texs)
    return flat, merged, mtex_id


def _queries(rng, n_tex):
    """Texture ids, UVs (wrapping both ways), lambdas past both ends of
    the mip chain, and uint32 seeds."""
    return {"tid": rng.integers(0, n_tex, R).astype(np.int32),
            "uv": rng.uniform(-2.5, 3.5, (R, 2)).astype(np.float32),
            "lam": rng.uniform(-1.0, 6.0, R).astype(np.float32),
            "seed": rng.integers(0, 1 << 32, R, dtype=np.uint64)
                       .astype(np.uint32)}


def _jt(q):
    """(jax, torch) views of the queries; seeds as uint32 and as the
    port's int64 words."""
    j = {k: jnp.asarray(v) for k, v in q.items()}
    t = {k: torch.from_numpy(v) for k, v in q.items() if k != "seed"}
    t["seed"] = torch.from_numpy(q["seed"].astype(np.int64))
    return j, t


def _flat(atlases):
    flat = atlases[0]
    return ((jnp.asarray(flat["atlas"]), jnp.asarray(flat["desc"])),
            (torch.from_numpy(flat["atlas"]), torch.from_numpy(flat["desc"])))


@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
def test_fetch_at_one_level(atlases, kind):
    (ja, jd), (ta, td) = _flat(atlases)
    q = _queries(np.random.default_rng(43), jd.shape[0])
    lev = np.random.default_rng(44).integers(0, jd.shape[1], R)
    dsc = np.asarray(atlases[0]["desc"])[q["tid"], lev]
    j, t = _jt(q)
    args = [dsc[:, i].copy() for i in range(3)]
    ref = getattr(jshade, f"fetch_texel_{kind}")(
        ja, *map(jnp.asarray, args), j["uv"])
    got = getattr(tshade, f"fetch_texel_{kind}")(
        ta, *map(torch.from_numpy, args), t["uv"])
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **FETCH_TOL)


@pytest.mark.parametrize("filt", ["trilinear", "bilinear", "nearest"])
def test_fetch_texel_trilinear(atlases, filt):
    (ja, jd), (ta, td) = _flat(atlases)
    j, t = _jt(_queries(np.random.default_rng(45), jd.shape[0]))
    ref = jshade.fetch_texel_trilinear(ja, jd, j["tid"], j["uv"], j["lam"],
                                       filter=filt)
    got = tshade.fetch_texel_trilinear(ta, td, t["tid"], t["uv"], t["lam"],
                                       filter=filt)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **FETCH_TOL)


def test_fetch_texel_stochastic_bitwise(atlases):
    (ja, jd), (ta, td) = _flat(atlases)
    j, t = _jt(_queries(np.random.default_rng(47), jd.shape[0]))
    ref, rseed = jshade.fetch_texel_stochastic(ja, jd, j["tid"], j["uv"],
                                               j["lam"], j["seed"])
    got, gseed = tshade.fetch_texel_stochastic(ta, td, t["tid"], t["uv"],
                                               t["lam"], t["seed"])
    assert np.array_equal(np.asarray(ref), got.numpy())
    assert np.array_equal(np.asarray(rseed).astype(np.int64), gseed.numpy())


def _merged(atlases):
    merged = atlases[1]
    mt = scene_data.scene_to_torch(merged, "cpu")
    return ((jnp.asarray(merged["matlas"]),
             jnp.asarray(merged["matlas_desc"])),
            (mt["matlas"], mt["matlas_desc"]))


def test_fetch_merged_stochastic_bitwise(atlases):
    (jm, jd), (tm, td) = _merged(atlases)
    j, t = _jt(_queries(np.random.default_rng(49), jd.shape[0]))
    ref, rseed = jshade.fetch_merged_stochastic(jm, jd, j["tid"], j["uv"],
                                                j["lam"], j["seed"])
    got, gseed = tshade.fetch_merged_stochastic(tm, td, t["tid"], t["uv"],
                                                t["lam"], t["seed"])
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(rseed).astype(np.int64), gseed.numpy())


def test_fetch_merged_trilinear(atlases):
    (jm, jd), (tm, td) = _merged(atlases)
    j, t = _jt(_queries(np.random.default_rng(51), jd.shape[0]))
    ref = jshade.fetch_merged_trilinear(jm, jd, j["tid"], j["uv"], j["lam"])
    got = tshade.fetch_merged_trilinear(tm, td, t["tid"], t["uv"], t["lam"])
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **FETCH_TOL)


def test_matlas_bit_pattern_through_scene_to_torch():
    """Alpha 255 puts an RGBA8 word at or above 2^31: the merged atlas
    crosses as its int32 bit pattern and unpacks to the same bytes."""
    img = np.ones((4, 4, 4), np.float32)
    img[..., 0] = 0.25
    mat = JHostMaterial()
    mat.maps[0].texture_id = 0
    merged, _ = j_texture.build_merged_material_atlas(
        [mat], [JTexture.from_array(img)])
    words = merged["matlas"]
    assert words.dtype == np.uint32 and words.max() >= (1 << 31)
    t = scene_data.scene_to_torch(merged, "cpu")["matlas"]
    assert t.dtype == torch.int32
    assert np.array_equal(t.numpy().view(np.uint32), words)
    rgba = tshade._unpack_rgba8(t[:, 0])
    assert np.array_equal(rgba.numpy(),
                          np.asarray(jshade._unpack_rgba8(
                              jnp.asarray(words[:, 0]))))
    assert float(rgba[:, 3].min()) == 1.0


def _textured_system(layers: bool):
    """rfw_tpu's host side of a textured scene: three quads whose
    materials bind diffuse (with alpha cutout), normal and roughness maps,
    one untextured material, and with ``layers`` the additive diffuse and
    normal layers and a UV transform (both make the merged atlas
    ineligible)."""
    rng = np.random.default_rng(53)
    rs = JRenderSystem("wavefront")
    tids = [rs.materials.add_texture(JTexture.from_array(img))
            for img in _images(rng)]
    a = JHostMaterial(roughness=0.6, metallic=0.4, alpha_cutout=True)
    for slot, tid in ((0, tids[0]), (1, tids[1]), (3, tids[2])):
        a.maps[slot].texture_id = tid
    b = JHostMaterial(color=np.float32([0.3, 0.8, 0.5]), roughness=0.4)
    b.maps[0].texture_id = tids[3]
    b.maps[1].texture_id = tids[2]
    if layers:
        b.maps[0].uv_scale, b.maps[0].uv_offset = (2.0, 0.5), (0.25, -0.5)
        for slot, tid in ((5, tids[1]), (6, tids[0]), (7, tids[3]),
                          (8, tids[0])):
            b.maps[slot].texture_id = tid
    mats = [rs.materials.add(a), rs.materials.add(b),
            rs.add_material([0.7, 0.2, 0.2])]
    quads = (([0, 1, 0], [0, 0, 0]), ([0, 0, -1], [0, 1, 2]),
             ([1, 0, 0], [-2, 1, 0]))
    for (n, p), m in zip(quads, mats):
        rs.add_instance(rs.add_quad(n, p, 4.0, 3.0, m))
    rs.synchronize()
    eng = rs.context
    return jax_sd.build_device_scene(
        eng._instance_list(), eng._materials, eng._lights, None, eng._atlas,
        eng.config, area_light_overrides=eng._light_overrides)


@pytest.fixture(scope="module")
def textured_scenes():
    return {"merged": _textured_system(False),
            "per_map": _textured_system(True)}


@pytest.mark.parametrize("path,filt", [
    ("merged", "stochastic"), ("merged", "trilinear"),
    ("per_map", "stochastic"), ("per_map", "trilinear"),
    ("per_map", "bilinear"), ("per_map", "nearest")])
def test_get_shading_data_textured(textured_scenes, path, filt):
    scene_np = textured_scenes[path]
    assert ("matlas" in scene_np) == (path == "merged")
    keys = ["tri_pack", "materials", "atlas", "atlas_desc"]
    if path == "merged":
        keys += ["matlas", "matlas_desc"]
    scene_np = {k: scene_np[k] for k in keys}
    scene_t = scene_data.scene_to_torch(scene_np, "cpu")
    rng = np.random.default_rng(59)
    n_tri = scene_np["tri_pack"].shape[0]
    prim = rng.integers(0, n_tri, R).astype(np.int32)
    u = rng.random(R).astype(np.float32)
    v = (rng.random(R) * (1 - u)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cone = rng.uniform(1e-4, 0.1, R).astype(np.float32)
    seed = rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(np.uint32)
    flags = {k: True for k in ("diffuse", "normal", "rough",
                               "diffuse_layers", "normal_layers")}
    j_seed = jnp.asarray(seed) if filt == "stochastic" else None
    t_seed = (torch.from_numpy(seed.astype(np.int64))
              if filt == "stochastic" else None)
    ref = jshade.get_shading_data(
        {k: jnp.asarray(x) if isinstance(x, np.ndarray) else
         {kk: jnp.asarray(vv) for kk, vv in x.items()}
         for k, x in scene_np.items()},
        jnp.asarray(prim), jnp.asarray(u), jnp.asarray(v), jnp.asarray(d),
        jnp.asarray(cone), tex_flags=flags, tex_filter=filt,
        stoch_seed=j_seed)
    got = tshade.get_shading_data(
        scene_t, *map(torch.from_numpy, (prim, u, v, d, cone)),
        tex_flags=flags, tex_filter=filt, stoch_seed=t_seed)
    sd_j, sd_t = ref[0], got[0]
    assert sd_j.keys() == sd_t.keys()
    for k in sd_j:
        np.testing.assert_allclose(np.asarray(sd_j[k]), sd_t[k].numpy(),
                                   err_msg=k, **SHADE_TOL)
    for a, b in zip(ref[1:], got[1:]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **SHADE_TOL)
    cut = got[-1].numpy()
    assert 0 < cut.sum() < R           # some lanes cut, some kept


def test_odd_size_mip_chain():
    """A 37x53 image loads: each level is floor(size / 2), the mean of
    2x2 blocks of the level above with its odd last row or column
    dropped."""
    img = np.random.default_rng(61).random((37, 53, 4), dtype=np.float32)
    tex = texture.Texture.from_array(img)
    assert [m.shape[:2] for m in tex.mips] == [(37, 53), (18, 26), (9, 13),
                                               (4, 6), (2, 3)]
    for hi, lo in zip(tex.mips, tex.mips[1:]):
        h, w = lo.shape[:2]
        want = hi[:2 * h, :2 * w].reshape(h, 2, w, 2, 4).mean(axis=(1, 3))
        assert np.array_equal(lo, want.astype(np.float32))
    # a level of one row or column repeats its edge
    thin = texture.Texture.from_array(np.ones((1, 6, 4), np.float32))
    assert [m.shape[:2] for m in thin.mips] == [(1, 6), (1, 3), (1, 1),
                                                (1, 1), (1, 1)]
    atlas = texture.build_texture_atlas([tex])
    assert atlas["atlas"].shape[0] == sum(m.shape[0] * m.shape[1]
                                          for m in tex.mips)


def test_texture_cache_dir_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("RFW_NO_TEX_CACHE")
    monkeypatch.delenv("RFW_TEX_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert texture._cache_dir() == str(
        tmp_path / ".cache" / "rfw_tpu_torch" / "tex")
    monkeypatch.setenv("RFW_TEX_CACHE_DIR", str(tmp_path / "elsewhere"))
    assert texture._cache_dir() == str(tmp_path / "elsewhere")
