"""The port's own copies of rfw_tpu's host modules (config, camera,
scene loaders, lights, the test sky, textures, the native BVH builder,
animation samplers, skinning and the skinned glTF of config 4) against
the originals.

Both sides are numpy (or C++) on the same inputs, so equality is exact.
The inputs are files and lights made from a numpy seed."""

import base64
import dataclasses
import json
import shutil
import time

import numpy as np
import pytest

import rfw_tpu.camera as j_camera
import rfw_tpu.config as j_config
import rfw_tpu.native as j_native
import rfw_tpu.scene as j_scene
import rfw_tpu.scene.lights as j_lights
from rfw_tpu.bvh import builder as j_builder
from rfw_tpu.scene import skybox as j_skybox
from rfw_tpu.scene import texture as j_texture

import test_fbx
import test_loaders
import rfw_tpu_torch.scene as scene
from rfw_tpu_torch import camera, config, native
from rfw_tpu_torch.bvh import builder
from rfw_tpu_torch.scene import lights, skybox, texture
from rfw_tpu_torch.utils import synthetic


# rfw_tpu's options that the port never reads (README, deliberate
# deviations): TPU and JAX knobs, settings of features the port does not
# have, and the device refit's cell membership, which the port always
# rebuilds
REMOVED_OPTIONS = ("max_is_lights", "mip_level_count", "ibl_width",
                   "ibl_height", "device_rebuild_cells", "dtype",
                   "compact_via_sort", "use_pallas")


def test_render_config_defaults_equal():
    """The port's options are rfw_tpu's, in its order, less the eight it
    never reads, each with the reference's default."""
    ref, port = j_config.RenderConfig(), config.RenderConfig()
    names = [f.name for f in dataclasses.fields(port)]
    ref_names = [f.name for f in dataclasses.fields(ref)]
    assert set(REMOVED_OPTIONS) <= set(ref_names)
    assert names == [n for n in ref_names if n not in REMOVED_OPTIONS]
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name


def test_camera_view_equal():
    views = []
    for mod in (j_camera, camera):
        cam = mod.Camera()
        cam.resize(320, 200)
        cam.fov = 47.0
        cam.look_at([1.0, 2.5, -6.0], [0.2, 1.0, 0.5])
        views.append((mod.Camera().get_view().as_pytree(),
                      cam.get_view().as_pytree()))
    for ref, port in zip(*views):
        assert ref.keys() == port.keys()
        for k in ref:
            assert np.array_equal(np.asarray(ref[k]), np.asarray(port[k])), k


def _soup(seed, n_tris=300):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5, 5, (n_tris * 3, 3)).astype(np.float32)
    nrm = rng.normal(size=pos.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    faces = rng.permutation(n_tris * 3).reshape(n_tris, 3).astype(np.int32)
    return pos, nrm, faces


def _write_obj(path, pos, nrm, faces):
    with open(path, "w") as f:
        for p in pos:
            f.write(f"v {p[0]:.7g} {p[1]:.7g} {p[2]:.7g}\n")
        for n in nrm:
            f.write(f"vn {n[0]:.7g} {n[1]:.7g} {n[2]:.7g}\n")
        for a, b, c in faces + 1:
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")


def _write_stl(path, pos, nrm, faces):
    """Binary STL: one facet (normal, three corners) a face."""
    rec = np.zeros(len(faces), dtype=[("n", "<f4", (3,)),
                                      ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["n"] = nrm[faces[:, 0]]
    rec["v"] = pos[faces]
    with open(path, "wb") as f:
        f.write(b"seeded soup".ljust(80, b" "))
        f.write(np.uint32(len(faces)).tobytes())
        f.write(rec.tobytes())


def _write_gltf(path, pos, nrm, faces):
    """glTF 2.0 with one data-URI buffer: positions, normals, uint32
    indices, one mesh under one translated node."""
    blobs = [pos.astype("<f4").tobytes(), nrm.astype("<f4").tobytes(),
             faces.astype("<u4").tobytes()]
    offs = np.cumsum([0] + [len(b) for b in blobs])
    data = base64.b64encode(b"".join(blobs)).decode("ascii")
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": int(offs[-1]),
                     "uri": f"data:application/octet-stream;base64,{data}"}],
        "bufferViews": [{"buffer": 0, "byteOffset": int(o),
                         "byteLength": len(b)}
                        for o, b in zip(offs, blobs)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": len(nrm),
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5125, "count": faces.size,
             "type": "SCALAR"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0,
                                                   "NORMAL": 1},
                                    "indices": 2}]}],
        "nodes": [{"mesh": 0, "translation": [0.5, -1.0, 2.0]}],
        "scenes": [{"nodes": [0]}], "scene": 0}
    with open(path, "w") as f:
        json.dump(doc, f)


WRITERS = {"ply": synthetic.write_ply, "obj": _write_obj,
           "stl": _write_stl, "gltf": _write_gltf}


@pytest.mark.parametrize("ext", sorted(WRITERS))
def test_loaders_give_equal_triangles(tmp_path, ext):
    pos, nrm, faces = _soup(11)
    path = str(tmp_path / f"soup.{ext}")
    WRITERS[ext](path, pos, nrm, faces)
    objs = [pkg.load_object(path, pkg.MaterialList())
            for pkg in (j_scene, scene)]
    assert len(objs[0].meshes) == len(objs[1].meshes) >= 1
    for m_ref, m_port in zip(objs[0].meshes, objs[1].meshes):
        t_ref, t_port = m_ref.triangles(), m_port.triangles()
        assert t_port.count == t_ref.count == len(faces)
        for f in dataclasses.fields(t_ref):
            a, b = getattr(t_ref, f.name), getattr(t_port, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name



def _ply_faces(path, fmt, faces):
    """A binary PLY (``fmt``: "<" or ">") of the unit square's corners
    and ``faces``, each a list of indices (uchar count, int indices)."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                     fmt + "f4")
    order = "little" if fmt == "<" else "big"
    body = verts.tobytes() + b"".join(
        np.array([len(f)], "u1").tobytes()
        + np.array(f, fmt + "i4").tobytes() for f in faces)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_{order}_endian 1.0\nelement vertex 4\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 ).encode("ascii") + body)


@pytest.mark.parametrize("fmt,faces", [
    ("<", [[0, 1, 2, 3], [0, 2, 3]]),       # a quad: the face by face path
    (">", [[0, 1, 2], [0, 2, 3]]),          # triangles read at once
    ("<", [[0, 1, 2], [0, 2, 3], [1, 2, 3, 0]])])
def test_ply_face_blocks_equal(tmp_path, fmt, faces):
    path = str(tmp_path / "faces.ply")
    _ply_faces(path, fmt, faces)
    t_ref, t_port = (pkg.load_object(path, pkg.MaterialList()).meshes[0]
                     .triangles() for pkg in (j_scene, scene))
    assert t_port.count == t_ref.count == sum(len(f) - 2 for f in faces)
    for f in dataclasses.fields(t_ref):
        a, b = getattr(t_ref, f.name), getattr(t_port, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name

def _write_dae(path):
    with open(path, "w") as f:
        f.write(test_loaders._DAE)


def _write_fbx_ascii(path):
    with open(path, "w") as f:
        f.write(test_fbx._ASCII_FBX)


# tests/test_loaders.py's Collada quad (polylist, node translate, bound
# lambert material) and tests/test_fbx.py's binary (zlib arrays, a quad
# to triangulate, uvs, a model translation, a material) and ASCII quads
SCENE_FILES = {"dae": ("quad.dae", _write_dae),
               "fbx": ("quad.fbx", test_fbx._write_fbx),
               "fbx_ascii": ("quad_ascii.fbx", _write_fbx_ascii)}


@pytest.mark.parametrize("kind", sorted(SCENE_FILES))
def test_collada_and_fbx_loaders_equal(tmp_path, kind):
    name, write = SCENE_FILES[kind]
    path = str(tmp_path / name)
    write(path)
    mls = [pkg.MaterialList() for pkg in (j_scene, scene)]
    objs = [pkg.load_object(path, ml) for pkg, ml in zip((j_scene, scene),
                                                         mls)]
    assert len(objs[0].meshes) == len(objs[1].meshes) == 1
    t_ref, t_port = (o.meshes[0].triangles() for o in objs)
    assert t_port.count == t_ref.count == 2
    assert t_port.vertices[..., 0].min() >= 2.0 - 1e-6   # the translation
    for f in dataclasses.fields(t_ref):
        a, b = getattr(t_ref, f.name), getattr(t_port, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    mats = [ml.generate_device_materials() for ml in mls]
    assert mats[0].keys() == mats[1].keys()
    for k in mats[0]:
        assert np.array_equal(mats[0][k], mats[1][k]), k
    mid = int(np.atleast_1d(t_port.material)[0])
    assert np.allclose(mats[1]["color"][mid], [0.8, 0.1, 0.1], atol=1e-6)


@pytest.mark.parametrize("name, body", [("bad.dae", b"<notcollada/>"),
                                        ("bad.fbx", b"not an fbx file")])
def test_collada_and_fbx_reject_malformed(tmp_path, name, body):
    p = tmp_path / name
    p.write_bytes(body)
    for pkg in (j_scene, scene):
        with pytest.raises(ValueError):
            pkg.load_object(str(p), pkg.MaterialList())


def _lights(mod, rng):
    def v3():
        return rng.uniform(-4, 4, 3).astype(np.float32)
    area = [mod.AreaLight(vertex0=v3(), vertex1=v3(), vertex2=v3(),
                          normal=np.float32([0, -1, 0]), radiance=v3() ** 2,
                          area=float(rng.uniform(0.1, 2)), tri_idx=i,
                          inst_idx=0) for i in range(3)]
    point = [mod.PointLight(v3(), v3() ** 2) for _ in range(2)]
    spot = [mod.SpotLight(v3(), np.float32([0, -1, 0]), v3() ** 2, 0.9, 0.8)]
    dirl = [mod.DirectionalLight(np.float32([0.6, -0.8, 0]), v3() ** 2)]
    return area, point, spot, dirl


def test_pack_lights_equal():
    ref = j_lights.pack_lights(*_lights(j_lights, np.random.default_rng(3)))
    port = lights.pack_lights(*_lights(lights, np.random.default_rng(3)))
    assert ref.keys() == port.keys()
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _reference_native(monkeypatch, timeout_s: float = 60.0):
    """rfw_tpu's native library, loaded. rfw_tpu compiles it at first use
    straight into its final path, so under several test workers another
    worker may still be writing it when this one tries to load it; the
    failed load is cached for the process. Retry, resetting that cache,
    until the library loads or ``timeout_s`` passes."""
    deadline = time.monotonic() + timeout_s
    while j_native._load() is None:
        if time.monotonic() > deadline:
            pytest.fail("rfw_tpu's native library did not load within "
                        f"{timeout_s:.0f} s")
        time.sleep(0.5)
        monkeypatch.setattr(j_native, "_TRIED", False)


def test_native_bvh_build_equal(monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++: neither native BVH library can be built")
    _reference_native(monkeypatch)
    assert native.available(), "the port's native library did not build"
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    pos, _, faces = _soup(5, n_tris=2000)
    tmin, tmax = j_builder.triangle_bounds(pos[faces])
    assert np.array_equal(builder.triangle_bounds(pos[faces])[0], tmin)
    for name, args in (("native_build_bvh", (4,)),
                       ("native_build_bvh_loc", (4,)),
                       ("native_spatial_treelets", (128,))):
        ref = getattr(j_native, name)(tmin, tmax, *args)
        port = getattr(native, name)(tmin, tmax, *args)
        assert ref is not None and port is not None, name
        for a, b in zip(ref, port):
            assert np.array_equal(a, b), name
    bvh = builder.build_bvh(tmin, tmax, leaf_size=4)
    for name, args in (("native_collapse_wide", (4,)),
                       ("native_extract_treelets", (128,))):
        ref = getattr(j_native, name)(bvh, *args)
        port = getattr(native, name)(bvh, *args)
        for a, b in zip(ref, port):
            assert np.array_equal(a, b), name


def _assert_tables_equal(ref: dict, port: dict) -> None:
    assert ref.keys() == port.keys()
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("size", [(512, 256), (67, 33)],
                         ids=["default", "odd"])
def test_test_sky_equal(size):
    """``Skybox.test_sky()`` (the 1080p slices' sky) and its device and
    importance tables, pixel for pixel."""
    ref, port = j_skybox.Skybox.test_sky(*size), skybox.Skybox.test_sky(*size)
    assert port.pixels.shape == (size[1], size[0], 3)
    assert port.pixels.dtype == ref.pixels.dtype
    assert np.array_equal(port.pixels, ref.pixels)
    _assert_tables_equal(ref.as_device(), port.as_device())
    _assert_tables_equal(ref.build_importance_tables(),
                         port.build_importance_tables())


@pytest.mark.parametrize("shape", [(32, 32), (48, 80)],
                         ids=["square", "wide"])
def test_texture_load_and_mips_equal(tmp_path, monkeypatch, shape):
    """A seeded RGBA8 PNG through both ``Texture.load`` (sRGB to linear,
    the 5-level box-filtered mip chain), a seeded float image through
    ``Texture.from_array``, and the flat atlas of both. The sizes halve
    evenly down the chain: both copies raise on a level of odd size."""
    from PIL import Image
    monkeypatch.setenv("RFW_NO_TEX_CACHE", "1")     # no cache under HOME
    rng = np.random.default_rng(23)
    path = str(tmp_path / "seeded.png")
    Image.fromarray(rng.integers(0, 256, (*shape, 4), dtype=np.uint8),
                    "RGBA").save(path)
    base = rng.random((*shape, 3), dtype=np.float32)
    pairs = [(j_texture.Texture.load(path), texture.Texture.load(path)),
             (j_texture.Texture.from_array(base),
              texture.Texture.from_array(base))]
    for ref, port in pairs:
        assert len(port.mips) == len(ref.mips) == texture.MIP_LEVEL_COUNT
        assert port.mips[0].shape == (*shape, 4)
        for a, b in zip(ref.mips, port.mips):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    _assert_tables_equal(
        j_texture.build_texture_atlas([r for r, _ in pairs]),
        texture.build_texture_atlas([p for _, p in pairs]))


@pytest.mark.parametrize("interp", ["LINEAR", "STEP"])
def test_animation_sampler_equal(interp):
    """``Sampler.sample`` before, on, between and past its keyframes, for
    rotations (4 values) and translations (3)."""
    from rfw_tpu.scene import animation as j_anim
    from rfw_tpu_torch.scene import animation as anim
    rng = np.random.default_rng(29)
    times = np.sort(rng.uniform(0.0, 2.0, 5)).astype(np.float32)
    ts = np.concatenate([[-0.5, 3.0], times, rng.uniform(-0.1, 2.1, 40)])
    for width in (3, 4):
        values = rng.normal(size=(5, width)).astype(np.float32)
        ref = j_anim.Sampler(times=times, values=values, interpolation=interp)
        port = anim.Sampler(times=times, values=values, interpolation=interp)
        for t in ts:
            a, b = ref.sample(float(t)), port.sample(float(t))
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b), (width, t)
    q = rng.normal(size=4).astype(np.float32)
    assert np.array_equal(j_anim.compose_trs([1, 2, 3], q, [2, 1, 0.5]),
                          anim.compose_trs([1, 2, 3], q, [2, 1, 0.5]))


def test_skinning_equal():
    """``joint_matrices``, ``apply_skin`` and ``apply_morphs`` on seeded
    joints, weights and morph targets."""
    from rfw_tpu.scene import skinning as j_skin
    from rfw_tpu_torch.scene import skinning as skin
    rng = np.random.default_rng(31)
    n_joints, n_verts = 5, 200
    world = rng.normal(size=(n_joints, 4, 4)).astype(np.float32)
    world[:, 3] = [0, 0, 0, 1]
    ibm = rng.normal(size=(n_joints, 4, 4)).astype(np.float32)
    ibm[:, 3] = [0, 0, 0, 1]
    mesh_inv = rng.normal(size=(4, 4)).astype(np.float32)
    pos = rng.normal(size=(n_verts, 3)).astype(np.float32)
    nrm = rng.normal(size=(n_verts, 3)).astype(np.float32)
    joints = rng.integers(0, n_joints, (n_verts, 4)).astype(np.int32)
    weights = rng.random((n_verts, 4)).astype(np.float32)
    morph_p = rng.normal(size=(3, n_verts, 3)).astype(np.float32)
    morph_n = rng.normal(size=(3, n_verts, 3)).astype(np.float32)
    mw = rng.random(3).astype(np.float32)
    pairs = [((j_skin.joint_matrices(world, ibm),),
              (skin.joint_matrices(world, ibm),)),
             ((j_skin.joint_matrices(world, ibm, mesh_inv),),
              (skin.joint_matrices(world, ibm, mesh_inv),))]
    jm = pairs[0][1][0]
    pairs += [(j_skin.apply_skin(pos, nrm, joints, weights, jm),
               skin.apply_skin(pos, nrm, joints, weights, jm)),
              (j_skin.apply_skin(pos, None, joints, weights, jm)[:1],
               skin.apply_skin(pos, None, joints, weights, jm)[:1]),
              (j_skin.apply_morphs(pos, nrm, morph_p, morph_n, mw),
               skin.apply_morphs(pos, nrm, morph_p, morph_n, mw)),
              (j_skin.apply_morphs(pos, None, morph_p, None, mw)[:1],
               skin.apply_morphs(pos, None, morph_p, None, mw)[:1])]
    for ref, port in pairs:
        assert len(ref) == len(port)
        for a, b in zip(ref, port):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_skinned_gltf_equal(tmp_path):
    """The skinned glTF that config 4 runs on (``rfw_tpu_torch.utils.
    synthetic.write_skinned_gltf``): skins, inverse-bind matrices,
    JOINTS_0 and WEIGHTS_0, the animation, and the posed triangles at
    t = 0.5."""
    path = str(tmp_path / "tube.gltf")
    n = synthetic.write_skinned_gltf(path, 3, around=24, rings=10)
    objs = [pkg.load_object(path, pkg.MaterialList())
            for pkg in (j_scene, scene)]
    ref, port = objs
    assert len(port.skins) == len(ref.skins) == 1
    assert port.skins[0].joint_nodes == ref.skins[0].joint_nodes == [0, 1]
    assert np.array_equal(port.skins[0].inverse_bind,
                          ref.skins[0].inverse_bind)
    assert port.skins[0].inverse_bind[1, 1, 3] == -0.5 * synthetic.TUBE_LENGTH
    m_ref, m_port = ref.meshes[0], port.meshes[0]
    assert m_port.skin_id == m_ref.skin_id == 0
    for attr in ("joints", "weights", "base_positions", "base_normals",
                 "uv", "indices"):
        a, b = getattr(m_ref, attr), getattr(m_port, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert np.allclose(m_port.weights.sum(1), 1.0)
    assert port.is_animated and ref.is_animated
    for t in (0.5, 0.25):
        assert ref.set_time(t) and port.set_time(t)
        t_ref, t_port = m_ref.triangles(), m_port.triangles()
        assert t_port.count == n
        for f in dataclasses.fields(t_ref):
            a, b = getattr(t_ref, f.name), getattr(t_port, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    # the pose bends the tube: its top left the axis
    assert float(np.abs(t_port.vertices[..., [0, 2]]).max()) > 0.3
