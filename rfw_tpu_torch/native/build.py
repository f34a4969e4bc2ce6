"""Compile the port's native libraries ahead of time:

    python -m rfw_tpu_torch.native.build [--only native|cuda]

The counterpart of ``python -m rfw_tpu.native.build``. It builds the two
libraries the port otherwise compiles at first use: the C++ BVH builder
(``g++``, ``native.GXX_FLAGS``) and the CUDA kernel library (``nvcc``,
``ops.cuda_lib.NVCC_FLAGS``, every source of ``csrc/``), each through its
loader's own ``_build``, under the hash-keyed name its loader looks for in
``rfw_tpu_torch/_build/``. A later ``load()`` finds them and builds
nothing, so the first frame does not pay for the compile. Each build
writes a temporary file and renames it, so a process that loads while
this runs never sees a half-written library.

It prints each command, each library's path and build seconds, and for
the kernel library the ptxas report of every kernel (registers, static
shared memory, stack and spill bytes). ``--only`` builds one of the two
(a machine without the CUDA toolkit builds ``native``). A failed compile
or a missing compiler exits with status 1 and the compiler's output;
unlike the runtime loader of the BVH builder, this entry point has no
fallback.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from . import _build as build_native
from . import library_path
from ..ops import cuda_lib


def _native() -> str:
    path = library_path()
    build_native(path, echo=print)
    return path


def _cuda() -> str:
    path = cuda_lib._library_path()
    cuda_lib._build(path, echo=print)
    return path


HALVES = {"native": ("the BVH builder (g++)", _native),
          "cuda": ("the CUDA kernel library (nvcc)", _cuda)}


def _report(log: str) -> None:
    for name, p in sorted(cuda_lib.ptxas_report(log).items()):
        print(f"{name}: {p.get('registers')} registers, {p.get('smem')} B "
              f"static shared memory, {p.get('stack')} B stack, "
              f"{p.get('spill_stores')}/{p.get('spill_loads')} B spill "
              f"stores/loads")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rfw_tpu_torch.native.build",
        description="Compile the port's BVH builder and CUDA kernel "
                    "library ahead of time.")
    ap.add_argument("--only", choices=tuple(HALVES),
                    help="build one of the two libraries")
    args = ap.parse_args(argv)
    for key in (args.only,) if args.only else tuple(HALVES):
        what, build = HALVES[key]
        t0 = time.perf_counter()
        try:
            path = build()
        except subprocess.CalledProcessError as e:
            print(f"building {what} failed ({e.returncode}):\n{e.stdout}"
                  f"{e.stderr}", file=sys.stderr)
            return 1
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            print(f"building {what} failed: {e}", file=sys.stderr)
            return 1
        print(f"{what}: {path}, built in "
              f"{time.perf_counter() - t0:.2f} s")
        if key == "cuda":
            _report(cuda_lib.build_log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
