"""Every kernel launch of the port runs with its input tensor's device as
the current CUDA device (``cuda_lib.launch``), on the CPU.

A ``<<<...>>>`` launch, ``cudaFuncSetAttribute`` and ``cudaGetLastError``
act on the calling thread's current device, while the wrappers pass the
stream of the tensor's device: without the guard, a launch on a tensor
of ``cuda:1`` would run on ``cuda:0`` with ``cuda:1``'s stream. Here
``cuda_lib.kernel_device`` is patched to take the kernel route for CPU
tensors, ``cuda_lib.load`` returns a fake library whose ``rfw_*``
entries record the current device, and ``torch.cuda.device`` and
``cuda_lib.stream`` are recorders: no CUDA is needed."""

import contextlib
import ctypes

import pytest
import torch

from chip_smoke import extend_args, nee_args
from rfw_tpu_torch.bvh import tlas
from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.ops import cuda_lib, extension, nee, traverse
from rfw_tpu_torch.ops import tvisit_intersect as tv
from rfw_tpu_torch.ops import visit_intersect as vi
from rfw_tpu_torch.render import scene_data
from rfw_tpu_torch.utils import synthetic


class Recorder:
    """Stands in for ``torch.cuda.device`` and ``cuda_lib.stream``, and
    is the fake kernel library: it keeps the stack of entered devices and
    a log of what happened under which stack."""

    def __init__(self, err: int = 0):
        self.err = err
        self.stack = []
        self.log = []

    @contextlib.contextmanager
    def device(self, dev):
        self.stack.append(torch.device(dev))
        self.log.append(("enter", torch.device(dev)))
        try:
            yield
        finally:
            self.stack.pop()
            self.log.append(("exit", torch.device(dev)))

    def stream(self, dev):
        self.log.append(("stream", torch.device(dev), tuple(self.stack)))
        return ctypes.c_void_p(0)

    def rfw_error_string(self, err):
        return b"fake error"

    def __getattr__(self, name):
        if not name.startswith("rfw_"):
            raise AttributeError(name)

        def entry(*args):
            self.log.append((name, tuple(self.stack)))
            return self.err
        return entry


def _rays(n):
    return torch.rand((8, n), generator=torch.Generator().manual_seed(n))


def _enum():
    rays = _rays(vi.BLOCK)
    return "rfw_enum_entries", rays, lambda: vi.block_entries(
        rays, torch.zeros((8, 4)), 4)


def _visit():
    rays = _rays(vi.BLOCK)
    gran = vi.Granules(planes=torch.zeros((2, 16, 4)),
                       planes_tm=torch.zeros((2, 4, 12)),
                       bounds8=torch.zeros((8, 2)), n_real=2, super_g=1,
                       k_size=4)
    ids = torch.zeros((1, 3), dtype=torch.int32)
    return "rfw_visit", rays, lambda: vi.visit(
        rays, ids, torch.ones(1, dtype=torch.int32), torch.zeros((1, 3)),
        gran, 1e-4, False)


def _expand():
    rays = _rays(vi.BLOCK)
    ids = torch.zeros((1, 2), dtype=torch.int32)
    return "rfw_expand", rays, lambda: tv.expand_children(
        ids, rays, torch.zeros((8, 3)), torch.ones((8, 3)),
        torch.tensor(2.0), 2)


def _tvisit():
    ns = 2
    rays = _rays(ns * tv.LANES)
    cids = torch.zeros((ns, 3), dtype=torch.int32)
    return "rfw_tvisit", rays, lambda: tv.tvisit(
        rays, cids, torch.ones(ns, dtype=torch.int32), torch.zeros((ns, 3)),
        torch.zeros((2, 16, 8)), torch.zeros((2, 8, 12)), 8, 1e-4, True)


def _traverse():
    origins = torch.zeros((5, 3))
    bvh = {"nodes": torch.zeros((1, 8, 4))}
    return "rfw_traverse", origins, lambda: traverse.traverse_wide(
        origins, torch.ones((5, 3)), bvh, torch.zeros((1, 3, 4)))


def _tlas_premask():
    origins = torch.zeros((5, 3))
    return "rfw_tlas_premask", origins, lambda: tlas.premask(
        torch.zeros((2, 3)), torch.ones((2, 3)), origins, torch.ones((5, 3)),
        torch.full((5,), 1e30), 1e-4)


def _tlas_walk():
    origins = torch.zeros((5, 3))
    rows = {"inst_bmin": torch.zeros((2, 3)), "inst_bmax": torch.ones((2, 3)),
            "inst_inv": torch.eye(4).repeat(2, 1, 1),
            "inst_base": torch.zeros(2, dtype=torch.int32),
            "nodes": torch.zeros((1, 8, 4)), "tri_table": torch.zeros((1, 3, 4)),
            "prim_order": torch.zeros(1, dtype=torch.int32)}
    return "rfw_tlas_walk", origins, lambda: tlas.walk_group(
        rows, origins, torch.ones((5, 3)), tlas.start_state(origins, 1e30),
        torch.arange(2, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
        torch.arange(5, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
        1e-4)


def _retransform():
    row = torch.zeros(5, dtype=torch.int32)
    obj = {k: torch.zeros((2, 3, 3) if k in ("vertices", "normals")
                          else (2, 3)) for k in scene_data.SLOT_PLANES}
    return "rfw_retransform", row, lambda: scene_data.retransform(
        row, torch.arange(5, dtype=torch.int32) % 2,
        torch.zeros(1, dtype=torch.int32), torch.zeros((1, 21)), obj,
        torch.zeros((5, 32)))


def _nee_lanes():
    return nee_args(synthetic.nee_case(1, 64, width=16, height=8), "cpu")


def _nee():
    scene, lanes = _nee_lanes()
    return "rfw_nee", lanes.pid, lambda: nee.nee(
        scene, RenderConfig(), nee.disney, lanes, 16, 8, 0, 3, {})


def _nee_add():
    scene, lanes = _nee_lanes()
    rays = nee.nee_plain(scene, RenderConfig(), nee.disney, lanes, 16, 8, 0,
                         3, {})
    radiance = torch.zeros((64, 3))
    return "rfw_nee_add", radiance, lambda: nee.add_unoccluded(
        radiance, rays, torch.zeros_like(rays.want))


def _extend():
    lanes, seed, state = extend_args(synthetic.extend_case(1, 64), "cpu")
    return "rfw_extend", lanes.i_n, lambda: extension.extend(
        RenderConfig(), nee.disney, lanes, seed, state)


WRAPPERS = {"enum": _enum, "visit": _visit, "expand": _expand,
            "tvisit": _tvisit, "traverse": _traverse,
            "tlas_premask": _tlas_premask, "tlas_walk": _tlas_walk,
            "retransform": _retransform, "nee": _nee, "nee_add": _nee_add,
            "extend": _extend}


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(cuda_lib, "kernel_device", lambda t, family: True)
    monkeypatch.setattr(cuda_lib, "load", lambda: rec)
    monkeypatch.setattr(cuda_lib, "stream", rec.stream)
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    counts = dict(cuda_lib.launch_counts)
    yield rec
    cuda_lib.launch_counts.update(counts)


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_launch_runs_under_the_tensors_device(recorder, kernel):
    entry, t, call = WRAPPERS[kernel]()
    before = cuda_lib.launch_counts[kernel]
    call()
    dev = t.device
    assert recorder.log == [("enter", dev), ("stream", dev, (dev,)),
                            (entry, (dev,)), ("exit", dev)]
    assert recorder.stack == []
    assert cuda_lib.launch_counts[kernel] == before + 1


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_guard_exits_after_a_failed_launch(recorder, kernel):
    recorder.err = 2
    entry, t, call = WRAPPERS[kernel]()
    before = cuda_lib.launch_counts[kernel]
    with pytest.raises(RuntimeError, match="CUDA error 2 \\(fake error\\)"):
        call()
    dev = t.device
    assert recorder.log == [("enter", dev), ("stream", dev, (dev,)),
                            (entry, (dev,)), ("exit", dev)]
    assert recorder.stack == []
    assert cuda_lib.launch_counts[kernel] == before
