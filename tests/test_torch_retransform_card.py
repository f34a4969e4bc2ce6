"""The re-transform kernel of a device update
(``rfw_tpu_torch/csrc/retransform_kernel.cu``) on the card: equal bit for
bit to its plain version, ``render/scene_data.py::retransform_ref``, on
the same CUDA tensors, at the benchmark sphereflake's layout
(``synthetic.retransform_case``, 1,049,608 triangles), and launched once
an update by an engine (a ``tlas`` move; a ``visit`` deformation and
move), whose new planes equal the plain version's on the engine's own
tables bit for bit, and a CPU engine's within 1e-6. The
plain version on the card's CPU differs from the same on its CUDA tensors
in the last bit of about 1 % of the unit vectors and areas (a square
root or quotient of the CPU's; 1.2e-7 at most on a sphereflake-sized
layout), so the CPU is held within 1e-6.

Every test needs a CUDA card and skips without one. On the card's
machine, which has no JAX (``tests/conftest.py`` imports it):
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_retransform_card.py``."""

import numpy as np
import pytest
import torch

from chip_smoke import retransform_args
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib
from rfw_tpu_torch.render import create_engine, scene_data
from rfw_tpu_torch.scene import make_quad
from rfw_tpu_torch.scene.mesh import build_triangles
from rfw_tpu_torch.utils import synthetic

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().cpu().view(torch.int32)


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_kernel_equals_its_plain_version_bit_for_bit(card, seed):
    case = synthetic.retransform_case(seed)
    args = retransform_args(case, card)
    before = cuda_lib.launch_counts["retransform"]
    got = scene_data.retransform(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["retransform"] == before + 1
    want = scene_data.retransform_ref(*args)
    on_cpu = scene_data.retransform_ref(*retransform_args(case, "cpu"))
    assert got.keys() == want.keys() == set(scene_data.MOVE_PLANES)
    for k in scene_data.MOVE_PLANES:
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
        torch.testing.assert_close(got[k].cpu(), on_cpu[k], rtol=0,
                                   atol=1e-6, msg=k)


def _engine(device, intersector):
    eng = create_engine("megakernel", RenderConfig(), device=device)
    v, f = synthetic.icosphere(2)
    eng.set_mesh(0, make_quad([0, 1, 0], [0, 0, 0], 8, 8, 0).triangles())
    eng.set_mesh(1, build_triangles(v, f))
    eng.set_instance(0, 0, np.eye(4, dtype=np.float32))
    for i in range(1, 6):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (1.5 * i - 4.5, 1.0, 0.5 * i)
        eng.set_instance(i, 1, m)
    eng.set_setting("intersector", intersector)
    eng.update()
    return eng


@pytest.mark.parametrize("intersector", ["tlas", "visit"])
def test_each_move_launches_the_kernel_once(card, intersector):
    """Three updates: under ``tlas`` three moves, under ``visit`` a
    deformation of the sphere mesh, a move, a deformation."""
    engines = {"cuda": _engine(card, intersector),
               "cpu": _engine("cpu", intersector)}
    rng = np.random.default_rng(3)
    v, f = synthetic.icosphere(2)
    for step in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = q * rng.uniform(0.5, 1.5, 3)
        m[:3, 3] = rng.uniform(-3.0, 3.0, 3)
        bent = build_triangles(
            (v * rng.uniform(0.8, 1.2, (len(v), 1))).astype(np.float32), f)
        deform = intersector == "visit" and step != 1
        before = cuda_lib.launch_counts["retransform"]
        pack = engines["cuda"]._scene["tri_pack"]
        for eng in engines.values():
            if deform:
                eng.set_mesh(1, bent)
            else:
                eng.set_instance(1 + step, 1, m)
            eng.update()
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts["retransform"] == before + 1
        eng = engines["cuda"]
        got, tables = eng._scene, eng._move_tables
        xf = torch.from_numpy(scene_data.instance_matrices(
            [im.transform for im in eng._instance_list()])).to(card)
        want = scene_data.retransform_ref(
            tables["row"], got["tri_prim"], tables["base"], xf,
            tables["obj"], pack)
        for k in scene_data.MOVE_PLANES:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (step, k)
            torch.testing.assert_close(
                got[k].cpu(), engines["cpu"]._scene[k], rtol=0, atol=1e-6,
                msg=(step, k))
