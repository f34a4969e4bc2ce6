"""rfw_tpu_torch — the rfw_tpu path tracer ported to PyTorch and CUDA.

Mirrors the module layout of ``rfw_tpu`` (``ops/``, ``ops/bsdf/``,
``render/``, ``parallel/``, ``system.py``, ``app.py``, ``viewer.py``) so
each counterpart is easy to find. Tensors live on the device named by
``RenderSystem(..., device=...)``, the CUDA card unless the caller asks
for ``"cpu"``; nothing here sets a global default device. The kernels of
the visit, tvisit and bvh intersectors are hand-written CUDA
(``csrc/``); on CPU tensors their plain PyTorch versions run instead.
``RenderConfig(n_devices=k)`` splits a frame into k row-block tiles
(``parallel/``), driven from one process. ``examples/`` holds the ports
of the repository's examples (``python -m rfw_tpu_torch.examples.<name>``)
and ``python -m rfw_tpu_torch.native.build`` compiles the native
libraries ahead of time.

The host-side modules (``config``, ``camera``, ``refs``, ``utils/``,
``scene/``, ``native/``) are the port's own copies of ``rfw_tpu``'s, with
their logic unchanged: the port imports nothing of ``rfw_tpu``.
``tests/test_torch_copies.py`` holds the copies to the originals.
"""

from .camera import Camera, CameraView
from .config import DEFAULT_CONFIG, RenderConfig

__all__ = ["Camera", "CameraView", "RenderConfig", "DEFAULT_CONFIG",
           "RenderSystem"]


def __getattr__(name):
    if name == "RenderSystem":
        from .system import RenderSystem
        return RenderSystem
    raise AttributeError(f"module 'rfw_tpu_torch' has no attribute {name!r}")
