"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file compiles on its own, with the shared headers
``csrc/*.cuh`` it includes, into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC [per-file flags] -o build/torch_kernels/lib<name>.so

The build runs at first use (one nvcc process per source, all started
together) into ``build/torch_kernels/`` at the checkout root, which git
ignores; a library newer than its source and every header is reused.
Nothing is built when this module is imported.
``python -m rx_tools_tpu_torch.kernels.build`` builds them all and prints
what ptxas reports for each kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: library name -> (source, extra nvcc flags)
SOURCES = {
    "capture_head": ("capture_head.cu", []),
    # no multiply-add contraction: the output is held to the plain
    # version's elementwise arithmetic
    "fused_capture_fm": ("fused_capture_fm.cu", ["--fmad=false"]),
    "int_deemph": ("int_deemph.cu", []),
}

_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report and seconds of the last build of each library
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _inputs(name: str, csrc: Path = CSRC) -> list[Path]:
    """The files a library is built from: its source and every shared
    header in ``csrc`` (a header edit rebuilds every library)."""
    return [csrc / SOURCES[name][0], *sorted(csrc.glob("*.cuh"))]


def _stale(name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> bool:
    lib = build_dir / f"lib{name}.so"
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(f.stat().st_mtime > built for f in _inputs(name, csrc))


def build(names=None, force: bool = False) -> None:
    """Compile the named libraries (all by default) in parallel.  Raises
    with nvcc's output when a compile fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        src, extra = SOURCES[name]
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing or stale."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


if __name__ == "__main__":
    build(force=True)
    for n in SOURCES:
        print(f"== {n} ({build_seconds[n]:.1f} s)\n{build_log[n]}")
