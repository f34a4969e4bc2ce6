"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. The sources share the device helpers of
``csrc/*.cuh``. The library lands in ``rfw_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed by the hash of the sources, their
headers and the flags: editing either rebuilds it at the next load.
Nothing is built at import time; ``load()`` builds on first use.

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them, so the kernels can be held to their
plain versions bit for bit. Division stays IEEE (no ``--use_fast_math``).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG, "csrc", f)
                for f in ("visit_kernels.cu", "expand_kernel.cu",
                          "tvisit_kernel.cu", "traverse_kernel.cu",
                          "tlas_kernel.cu", "retransform_kernel.cu",
                          "nee_kernel.cu", "extend_kernel.cu"))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_lib = None
build_seconds = 0.0
build_log = ""

# launches of each kernel since the last reset; a wrapper counts a launch
# of its kernel here and nowhere else (its plain version on CPU tensors
# does not count)
launch_counts = {"enum": 0, "visit": 0, "expand": 0, "tvisit": 0,
                 "traverse": 0, "tlas_premask": 0, "tlas_walk": 0,
                 "retransform": 0, "nee": 0, "nee_add": 0, "extend": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_device(t: torch.Tensor, family: str) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); any other device raises, naming the kernel
    ``family``."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no {family} kernels for device {t.device}")


def check_inputs(device, **tensors) -> None:
    """Each of ``name=(tensor, dtype)`` lies on ``device``, has that dtype
    and is contiguous, as the kernels' raw pointers need."""
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@contextlib.contextmanager
def launch(device):
    """The guard of one kernel launch on ``device``: yields the kernel
    library and ``device``'s current stream, with ``device`` the calling
    thread's current CUDA device. ``<<<...>>>``, ``cudaFuncSetAttribute``
    and ``cudaGetLastError`` act on the current device, so without the
    guard a launch on a tensor of ``cuda:1`` would run on ``cuda:0`` with
    ``cuda:1``'s stream. Run the ``lib.rfw_*`` call and its ``check``
    inside it."""
    lib = load()
    with torch.cuda.device(device):
        yield lib, stream(device)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def headers() -> list:
    """The headers beside the sources (``#include "..."`` finds them
    there)."""
    dirs = sorted({os.path.dirname(src) for src in SOURCES})
    return sorted(h for d in dirs for h in glob.glob(os.path.join(d, "*.cuh")))


def _library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *headers()):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"rfw_kernels_{h.hexdigest()[:16]}.so")


def _build(path: str, echo=None) -> None:
    """Compile into a temporary directory, then rename: concurrent
    processes never load a half-written library. ``echo``, given, is
    called with each command line before it runs."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(SOURCES))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(SOURCES, objs)]
        if echo is not None:
            for cmd in cmds:
                echo(" ".join(cmd))
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs, failed = [], []
        try:
            for src, proc in zip(SOURCES, procs):
                out, _ = proc.communicate(timeout=600)
                logs.append(out)
                if proc.returncode != 0:
                    failed.append(
                        f"{os.path.basename(src)} ({proc.returncode})")
        finally:
            for proc in procs:       # a timeout leaves none running
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               f"{build_log}")
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        if echo is not None:
            echo(" ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        with open(path + ".log", "w") as f:
            f.write(build_log)
        os.replace(lib, path)


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources on first use (``python
    -m rfw_tpu_torch.native.build`` builds it ahead of time, and then
    ``build_seconds`` stays 0). The build's compiler output (``-Xptxas
    -v``: registers, shared memory, spills) is in ``build_log``, kept
    beside a library that was built earlier."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    path = _library_path()
    if not os.path.exists(path):
        t0 = time.perf_counter()
        _build(path)
        build_seconds = time.perf_counter() - t0
    elif os.path.exists(path + ".log"):
        with open(path + ".log") as f:
            build_log = f.read()
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rfw_enum_entries.argtypes = [p, i, p, i, i, p, p]
    lib.rfw_enum_entries.restype = i
    lib.rfw_visit.argtypes = [p, i, p, p, p, i, p, i, i, i, f, i, p, p, p, p]
    lib.rfw_visit.restype = i
    lib.rfw_expand.argtypes = [p, i, p, i, i, p, p, p, p, i, f, f, p, p, p, p]
    lib.rfw_expand.restype = i
    lib.rfw_tvisit.argtypes = [p, i, p, p, p, i, p, i, i, f, i, p, p, p, p]
    lib.rfw_tvisit.restype = i
    lib.rfw_traverse.argtypes = [p, p, p, i, p, p, i, f, i, p, p, p, p, p]
    lib.rfw_traverse.restype = i
    lib.rfw_tlas_premask.argtypes = [p, p, p, p, i, f, p, p, i, p, p, p, p,
                                     p]
    lib.rfw_tlas_premask.restype = i
    lib.rfw_tlas_walk.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, p, p,
                                  p, p, p, p, i, f, i, p, p, p, p, p]
    lib.rfw_tlas_walk.restype = i
    lib.rfw_retransform.argtypes = [p, p, p, p, p, p, p, p, p, p, i, p, p, p,
                                    p, p, p, p, p, p]
    lib.rfw_retransform.restype = i
    lib.rfw_nee.argtypes = [p, p]          # the NeeArgs block, the stream
    lib.rfw_nee.restype = i
    lib.rfw_nee_add.argtypes = [p, i, p, p, p, i, i, p, p]
    lib.rfw_nee_add.restype = i
    lib.rfw_extend.argtypes = [p, p]       # the ExtendArgs block, the stream
    lib.rfw_extend.restype = i
    lib.rfw_error_string.argtypes = [i]
    lib.rfw_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err:
        msg = load().rfw_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def ptxas_report(log: str) -> dict:
    """Per kernel, what ``nvcc -Xptxas -v`` printed: registers, static
    shared memory, stack and spill bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d+(t?visit_kernel|enum_kernel|expand_kernel"
                          r"|traverse_kernel|tlas_premask_kernel"
                          r"|tlas_walk_kernel|retransform_kernel"
                          r"|nee_kernel|nee_add_kernel|extend_kernel)",
                          m.group(1))
            cur = out.setdefault(k.group(1) if k else m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       smem=int(smem.group(1)) if smem else 0)
    return out
