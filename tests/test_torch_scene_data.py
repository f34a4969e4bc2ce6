"""The port's host scene build equals rfw_tpu's, array for array.

Each side builds its instances with its own package's types from the
same numpy inputs, and both builds are numpy, so equality is exact.
Keys the port leaves out (the host refit's caches, TLAS tables, tables
no ported consumer reads) are simply not compared; the refits'
triangle order ``_perm_host`` is."""

import numpy as np
import pytest
import torch

from rfw_tpu import config as j_config
from rfw_tpu.render import scene_data as jax_sd
from rfw_tpu.scene.lights import pack_lights as j_pack_lights
from rfw_tpu.scene.materials import MaterialList as JMaterialList
from rfw_tpu.scene.mesh import build_triangles as j_build_triangles

import chip_smoke
import golden_scenes
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.scene.lights import pack_lights
from rfw_tpu_torch.scene.materials import MaterialList
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.system import RenderSystem


def _soup_instances(port: bool):
    rng = np.random.default_rng(7)
    nt = 800
    centers = rng.uniform(-10, 10, (16, 3))
    tri_c = centers[rng.integers(0, 16, nt)] + rng.normal(0, 1.2, (nt, 3))
    verts = (tri_c[:, None, :] + rng.normal(0, 0.35, (nt, 3, 3))).astype(
        np.float32)
    build, mats, lights, sd = (
        (build_triangles, MaterialList, pack_lights, scene_data) if port else
        (j_build_triangles, JMaterialList, j_pack_lights, jax_sd))
    soa = build(verts.reshape(-1, 3), np.arange(nt * 3).reshape(nt, 3))
    inst = sd.InstancedMesh(triangles=soa,
                            transform=np.eye(4, dtype=np.float32),
                            instance_id=0, mesh_slot=0)
    return ([inst], mats().generate_device_materials(),
            lights([], [], [], []), {})


def _config2_instances(port: bool):
    """Cornell walls, mirror, area lamp (with its light overrides) and
    point light, as each package's RenderSystem uploads config 2."""
    if port:
        rs = chip_smoke.make_config2(RenderSystem("wavefront",
                                                  device="cpu"))
    else:
        rs = golden_scenes.make_config2(size=16)
    rs.synchronize()
    eng = rs.context
    return (eng._instance_list(), eng._materials, eng._lights,
            eng._light_overrides)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("make", [_soup_instances, _config2_instances],
                         ids=["soup800", "config2"])
def test_build_device_scene_matches_reference(make):
    instances, mats, lights, overrides = make(port=False)
    ref = jax_sd.build_device_scene(instances, mats, lights, None, None,
                                    j_config.RenderConfig(),
                                    area_light_overrides=overrides)
    instances, mats, lights, overrides = make(port=True)
    port = scene_data.build_device_scene(instances, mats, lights, None,
                                         None, RenderConfig(),
                                         area_light_overrides=overrides)
    ref_leaves = dict(_leaves(ref))
    n = 0
    for key, val in _leaves(port):
        if key in ("materials", "lights"):
            continue
        want = ref_leaves[key]
        if isinstance(val, np.ndarray):
            assert val.dtype == want.dtype, key
            assert np.array_equal(val, want), key
            n += 1
        else:
            assert val == want, key
    assert n >= 20   # every tri_*, treelet and bvh table was compared


def test_scene_to_torch_keeps_dtypes():
    instances, mats, lights, _ = _soup_instances(port=False)
    cfg = j_config.RenderConfig()
    ref = jax_sd.build_device_scene(instances, mats, lights, None, None, cfg)
    t = scene_data.scene_to_torch(ref, "cpu")
    assert "_bvh_host" not in t and "_perm_host" not in t
    assert t["treelets"]["wplanes"].dtype == torch.float32
    assert t["treelets"]["slot_to_prim"].dtype == torch.int32
    assert t["tri_material"].dtype == torch.int32
    assert t["materials"]["emissive"].dtype == torch.bool
    assert t["treelets"]["size"] == cfg.treelet_size
    assert np.array_equal(t["tri_pack"].numpy(), ref["tri_pack"])
