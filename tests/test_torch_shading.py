"""Shading maths of the port against rfw_tpu on seeded inputs.

Float results match to rtol = atol = 1e-5: both compute the same float32
formulas, but XLA fuses multiply-adds and evaluates sin/cos/log/exp with
its own float32 approximations, a few ulps from the port's. Integers
(sort keys, picked light indices) match exactly. Roughness stays at or
above 0.2: a sampled direction carries those ulps into the GGX lobe,
whose slope at low roughness multiplies them past the tolerance (at
0.05 one pdf of ~100 of 4096 differed by 9e-5 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.ops import compaction as jcomp
from rfw_tpu.ops import light_sampling as jls
from rfw_tpu.ops import shade as jshade
from rfw_tpu.ops.bsdf import disney as jdisney
from rfw_tpu.render import scene_data as jax_sd

from golden_scenes import make_config2
from rfw_tpu_torch.ops import compaction as tcomp
from rfw_tpu_torch.ops import light_sampling as tls
from rfw_tpu_torch.ops import shade as tshade
from rfw_tpu_torch.ops.bsdf import disney as tdisney
from rfw_tpu_torch.render import scene_data

N = 4096
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _hemi(rng, n_vec):
    """Unit vectors on the side of ``n_vec``."""
    v = _unit(rng, n_vec.shape[0])
    return np.where((v * n_vec).sum(-1, keepdims=True) < 0, -v, v)


@pytest.fixture(scope="module")
def shading_inputs():
    rng = np.random.default_rng(17)
    u = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa
    sd = {"color": rng.uniform(0, 1, (N, 3)).astype(np.float32),
          "absorption": rng.uniform(0, 0.5, (N, 3)).astype(np.float32),
          "metallic": u(0, 1), "subsurface": u(0, 1), "specular": u(0, 1),
          "roughness": u(0.2, 1), "specular_tint": u(0, 1),
          "anisotropic": u(0, 1), "sheen": u(0, 1), "sheen_tint": u(0, 1),
          "clearcoat": u(0, 1), "clearcoat_gloss": u(0, 1),
          "transmission": np.where(rng.random(N) < 0.3, u(0, 1),
                                   0).astype(np.float32),
          "eta": u(1.1, 1.8)}
    n = _unit(rng, N)
    t_vec, b_vec = (x.numpy() for x in tshade.create_tangent_space(
        torch.from_numpy(n)))
    return {"sd": sd, "n": n, "t": t_vec, "b": b_vec, "wo": _hemi(rng, n),
            "wi": _unit(rng, N), "r3": u(0, 1), "r4": u(0, 1),
            "t_dist": u(0.1, 5), "backfacing": rng.random(N) < 0.3}


def _both(x):
    """(jax, torch) views of a dict of numpy inputs."""
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def test_tangent_space(shading_inputs):
    n = shading_inputs["n"]
    ref = jshade.create_tangent_space(jnp.asarray(n))
    got = tshade.create_tangent_space(torch.from_numpy(n))
    for a, b in zip(ref, got):
        _close(a, b)


def test_disney_evaluate(shading_inputs):
    x = shading_inputs
    sd_j, sd_t = _both(x["sd"])
    args = [x[k] for k in ("n", "t", "b", "wo", "wi")]
    ref = jdisney.evaluate_bsdf(sd_j, *map(jnp.asarray, args))
    got = tdisney.evaluate_bsdf(sd_t, *map(torch.from_numpy, args))
    for a, b in zip(ref, got):
        _close(a, b)


def test_disney_sample(shading_inputs):
    x = shading_inputs
    sd_j, sd_t = _both(x["sd"])
    args = [x[k] for k in ("n", "n", "t", "b", "wo", "t_dist", "backfacing",
                           "r3", "r4")]
    val_j, wi_j, pdf_j, st_j = jdisney.sample_bsdf(sd_j,
                                                   *map(jnp.asarray, args))
    val_t, wi_t, pdf_t, st_t = tdisney.sample_bsdf(sd_t,
                                                   *map(torch.from_numpy,
                                                        args))
    assert np.array_equal(np.asarray(st_j), st_t.numpy())
    for a, b in ((wi_j, wi_t), (pdf_j, pdf_t), (val_j, val_t)):
        _close(a, b)


@pytest.fixture(scope="module")
def config2_scene():
    rs = make_config2(size=16)
    rs.synchronize()
    eng = rs.context
    scene = jax_sd.build_device_scene(
        eng._instance_list(), eng._materials, eng._lights, None, None,
        eng.config, area_light_overrides=eng._light_overrides)
    return scene, scene_data.scene_to_torch(scene, "cpu")


@pytest.mark.parametrize("importance", [True, False])
def test_random_point_on_light(config2_scene, importance):
    lights_np = config2_scene[0]["lights"]
    lights_t = config2_scene[1]["lights"]
    rng = np.random.default_rng(23)
    pts = rng.uniform([-2.7, 0.1, -2.7], [2.7, 5.4, 2.7],
                      (N, 3)).astype(np.float32)
    x = {"r0": rng.random(N).astype(np.float32),
         "r1": rng.random(N).astype(np.float32), "pt": pts,
         "n": _unit(rng, N)}
    j, t = _both(x)
    ref = jls.random_point_on_light(
        {k: jnp.asarray(v) for k, v in lights_np.items()}, j["r0"], j["r1"],
        j["pt"], j["n"], importance_sample=importance)
    got = tls.random_point_on_light(lights_t, t["r0"], t["r1"], t["pt"],
                                    t["n"], importance_sample=importance)
    for k in ("light_index", "is_delta"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), k
    for k in ("position", "pick_prob", "light_pdf", "radiance"):
        _close(ref[k], got[k])


def test_get_shading_data(config2_scene):
    scene_np, scene_t = config2_scene
    rng = np.random.default_rng(29)
    n_tri = scene_np["tri_vertices"].shape[0]
    prim = rng.integers(0, n_tri, N).astype(np.int32)
    u = rng.random(N).astype(np.float32)
    v = (rng.random(N) * (1 - u)).astype(np.float32)
    d = _unit(rng, N)
    flags = {k: False for k in ("diffuse", "normal", "rough",
                                "diffuse_layers", "normal_layers")}
    ref = jshade.get_shading_data(
        {k: scene_np[k] for k in ("tri_pack", "materials")},
        jnp.asarray(prim), jnp.asarray(u), jnp.asarray(v), jnp.asarray(d),
        jnp.zeros(N), tex_flags=flags)
    got = tshade.get_shading_data(scene_t, torch.from_numpy(prim),
                                  torch.from_numpy(u), torch.from_numpy(v),
                                  torch.from_numpy(d), torch.zeros(N),
                                  tex_flags=flags)
    sd_j, sd_t = ref[0], got[0]
    assert sd_j.keys() == sd_t.keys()
    for k in sd_j:
        _close(sd_j[k], sd_t[k])
    for a, b in zip(ref[1:], got[1:]):
        _close(a, b)


def test_bound_diffuse_map_modulates_colour(config2_scene):
    """A diffuse map bound to a material multiplies its colour by the
    texel (here one constant texel, so every filter agrees)."""
    scene = dict(config2_scene[1])
    mats = dict(scene["materials"])
    mats["tex0_id"] = torch.zeros_like(mats["tex0_id"])
    scene["materials"] = mats
    texel = torch.tensor([0.5, 0.25, 1.0, 1.0])
    scene["atlas"] = texel.expand(8, 4).contiguous()
    desc = torch.zeros((1, 5, 3), dtype=torch.int32)
    desc[0, :, 1:] = 1
    scene["atlas_desc"] = desc
    n = 64
    prim = torch.arange(n, dtype=torch.int32) % scene["tri_pack"].shape[0]
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    plain = tshade.get_shading_data(config2_scene[1], prim, torch.full(
        (n,), 0.25), torch.full((n,), 0.25), d, torch.full((n,), 1e-3))[0]
    for filt in ("trilinear", "bilinear", "nearest", "stochastic"):
        sd = tshade.get_shading_data(
            scene, prim, torch.full((n,), 0.25), torch.full((n,), 0.25), d,
            torch.full((n,), 1e-3),
            tex_flags={"diffuse": True, "normal": False, "rough": False},
            tex_filter=filt, stoch_seed=torch.arange(n, dtype=torch.int64))[0]
        assert torch.equal(sd["color"], plain["color"] * texel[:3]), filt
        assert torch.equal(sd["roughness"], plain["roughness"])


def test_ray_sort_keys_exact():
    rng = np.random.default_rng(31)
    o = rng.uniform(-3, 9, (N, 3)).astype(np.float32)
    d = _unit(rng, N)
    d[:64, 1] = 0.0                        # zero components: octant edge
    lo = np.array([-2.0, 0.0, -1.5], np.float32)
    hi = np.array([6.0, 5.0, 4.5], np.float32)
    ref = jcomp.ray_sort_keys(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(lo), jnp.asarray(hi))
    got = tcomp.ray_sort_keys(*map(torch.from_numpy, (o, d, lo, hi)))
    assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())
