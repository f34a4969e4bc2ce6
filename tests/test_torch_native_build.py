"""``python -m rfw_tpu_torch.native.build``, the ahead-of-time build of the
port's two native libraries, on the CPU (no nvcc here).

* The BVH builder half compiles with g++ into the hash-keyed name that
  the runtime loader looks for, which then loads it and builds nothing.
* The CUDA half, driven by a stand-in nvcc (a script that writes the
  objects and the library and prints a recorded ptxas log), puts the
  library and its log where ``cuda_lib.load`` looks, and prints the
  commands and each kernel's ptxas report.
* A missing compiler or a failed compile exits 1 with the compiler's
  output: the entry point has no fallback.
* ``cuda_lib.ptxas_report`` parses a recorded ``-Xptxas -v`` log.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from rfw_tpu_torch import native
from rfw_tpu_torch.native import build
from rfw_tpu_torch.ops import cuda_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a log in the form nvcc -Xptxas -v prints (numbers made up, with a
# spill, and an entry that is none of the port's kernels)
PTXAS_LOG = textwrap.dedent("""\
    ptxas info    : 0 bytes gmem
    ptxas info    : Compiling entry function '_Z11enum_kernelPKfiS0_iiPf' for 'sm_90a'
    ptxas info    : Function properties for _Z11enum_kernelPKfiS0_iiPf
        0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
    ptxas info    : Used 38 registers, 16384 bytes smem, 400 bytes cmem[0]
    ptxas info    : Compiling entry function '_Z15traverse_kernelPKfS0_S0_iPK6float4S3_ifiPfPiS5_S5_' for 'sm_90a'
    ptxas info    : Function properties for _Z15traverse_kernelPKfS0_S0_iPK6float4S3_ifiPfPiS5_S5_
        256 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
    ptxas info    : Used 64 registers, 400 bytes cmem[0]
    ptxas info    : Compiling entry function '_Z6helperv' for 'sm_90a'
    ptxas info    : Used 4 registers, 352 bytes cmem[0]
    """)


def test_ptxas_report_parses_the_log():
    assert cuda_lib.ptxas_report(PTXAS_LOG) == {
        "enum_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 38, "smem": 16384},
        "traverse_kernel": {"stack": 256, "spill_stores": 8,
                            "spill_loads": 12, "registers": 64, "smem": 0},
        "_Z6helperv": {"registers": 4, "smem": 0}}


def test_kernel_sources_and_the_tlas_kernels():
    """The library builds eleven kernels from eight sources (one nvcc
    each) and the headers they share; the report names the two tlas
    kernels, the re-transform, the two NEE kernels and the extension."""
    names = [os.path.basename(s) for s in cuda_lib.SOURCES]
    assert names == ["visit_kernels.cu", "expand_kernel.cu",
                     "tvisit_kernel.cu", "traverse_kernel.cu",
                     "tlas_kernel.cu", "retransform_kernel.cu",
                     "nee_kernel.cu", "extend_kernel.cu"]
    assert all(os.path.exists(s) for s in cuda_lib.SOURCES)
    assert [os.path.basename(h) for h in cuda_lib.headers()] == [
        "bvh_walk.cuh", "kernel_common.cuh", "shading.cuh"]
    assert set(cuda_lib.launch_counts) == {
        "enum", "visit", "expand", "tvisit", "traverse", "tlas_premask",
        "tlas_walk", "retransform", "nee", "nee_add", "extend"}
    log = textwrap.dedent("""\
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119tlas_premask_kernelEPKfS1_S1_iS1_S1_iPjS2_' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_119tlas_premask_kernelEPKfS1_S1_iS1_S1_iPjS2_
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 32 registers, 2048 bytes smem, 400 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116tlas_walk_kernelEPKfS1_iS1_PKiS1_S1_S3_S3_S1_S1_S1_S3_PK6float4S6_S3_ifiPfPiS7_S7_' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_116tlas_walk_kernelEPKfS1_iS1_PKiS1_S1_S3_S3_S1_S1_S1_S3_PK6float4S6_S3_ifiPfPiS7_S7_
            256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 72 registers, 400 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118retransform_kernelEPKiS1_S1_PKfS3_S3_S3_S3_S3_S3_iPfS4_S4_S4_S4_S4_S4_S4_' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_118retransform_kernelEPKiS1_S1_PKfS3_S3_S3_S3_S3_S3_iPfS4_S4_S4_S4_S4_S4_S4_
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 40 registers, 37376 bytes smem, 504 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110nee_kernelENS_7NeeArgsE' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_110nee_kernelENS_7NeeArgsE
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 128 registers, 760 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114nee_add_kernelEPKfiS1_PKhS3_iiPf' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_114nee_add_kernelEPKfiS1_PKhS3_iiPf
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 16 registers, 408 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113extend_kernelENS_10ExtendArgsE' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_113extend_kernelENS_10ExtendArgsE
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 64 registers, 632 bytes cmem[0]
        """)
    assert cuda_lib.ptxas_report(log) == {
        "tlas_premask_kernel": {"stack": 0, "spill_stores": 0,
                                "spill_loads": 0, "registers": 32,
                                "smem": 2048},
        "tlas_walk_kernel": {"stack": 256, "spill_stores": 0,
                             "spill_loads": 0, "registers": 72, "smem": 0},
        "retransform_kernel": {"stack": 0, "spill_stores": 0,
                               "spill_loads": 0, "registers": 40,
                               "smem": 37376},
        "nee_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                       "registers": 128, "smem": 0},
        "nee_add_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                           "registers": 16, "smem": 0},
        "extend_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                          "registers": 64, "smem": 0}}


def test_native_half_builds_what_the_loader_loads(monkeypatch, capsys):
    assert build.main(["--only", "native"]) == 0
    path = native.library_path()
    out = capsys.readouterr().out
    assert os.path.exists(path)
    assert out.splitlines()[0].startswith("g++ ")
    assert f"{path}, built in " in out
    # the runtime loader finds it and builds nothing
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)

    def no_build(*a, **kw):
        raise AssertionError("the loader built the library again")

    monkeypatch.setattr(native, "_build", no_build)
    assert native._load() is not None


def test_module_entry_point_runs():
    out = subprocess.run([sys.executable, "-m", "rfw_tpu_torch.native.build",
                          "--only", "native"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert native.library_path() in out.stdout


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc: ``-c -o OBJ SRC`` writes OBJ and prints
    PTXAS_LOG, ``-shared -o LIB OBJS`` writes LIB."""
    log = tmp_path / "ptxas.log"
    log.write_text(PTXAS_LOG)
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        out = args[args.index("-o") + 1]
        with open(out, "w") as f:
            f.write("stand-in")
        if "-c" in args:
            sys.stdout.write(open({str(log)!r}).read())
        """))
    script.chmod(0o755)
    return str(script)


def test_cuda_half_puts_the_library_where_load_looks(tmp_path, monkeypatch,
                                                     capsys):
    nvcc = _fake_nvcc(tmp_path)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(cuda_lib, "build_log", "")
    assert build.main(["--only", "cuda"]) == 0
    path = cuda_lib._library_path()
    assert os.path.exists(path)
    with open(path + ".log") as f:
        assert f.read() == PTXAS_LOG * len(cuda_lib.SOURCES)
    lines = capsys.readouterr().out.splitlines()
    compiles = [ln for ln in lines if ln.startswith(nvcc) and " -c " in ln]
    assert len(compiles) == len(cuda_lib.SOURCES)
    assert all("-Xptxas -v" in ln for ln in compiles)
    assert any(ln.startswith(f"{nvcc} -shared -o ") for ln in lines)
    assert any(ln.startswith("the CUDA kernel library (nvcc): " + path)
               for ln in lines)
    assert ("enum_kernel: 38 registers, 16384 B static shared memory, 0 B "
            "stack, 0/0 B spill stores/loads") in lines
    assert ("traverse_kernel: 64 registers, 0 B static shared memory, 256 "
            "B stack, 8/12 B spill stores/loads") in lines
    # nothing is left of the build's temporary directory
    name = os.path.basename(path)
    assert sorted(os.listdir(tmp_path / "_build")) == [name, name + ".log"]


def test_missing_nvcc_exits_nonzero(monkeypatch, capsys):
    def missing():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")

    monkeypatch.setattr(cuda_lib, "_nvcc", missing)
    assert build.main(["--only", "cuda"]) == 1
    err = capsys.readouterr().err
    assert "nvcc" in err and "failed" in err
    assert build.main([]) == 1          # both halves: the CUDA one fails


def test_missing_gxx_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert build.main(["--only", "native"]) == 1
    assert "No such file or directory: 'g++'" in capsys.readouterr().err


def test_failed_compile_exits_with_the_compiler_output(monkeypatch, capsys):
    monkeypatch.setattr(native, "GXX_FLAGS",
                        (*native.GXX_FLAGS, "-include",
                         "no_such_header_rfw.h"))
    assert build.main(["--only", "native"]) == 1
    err = capsys.readouterr().err
    assert "the BVH builder (g++) failed" in err
    assert "no_such_header_rfw.h" in err
    assert not os.path.exists(native.library_path())


@pytest.mark.parametrize("argv", [["--only", "both"], ["--bogus"]])
def test_bad_arguments_exit_with_usage(argv):
    with pytest.raises(SystemExit) as e:
        build.main(argv)
    assert e.value.code == 2
