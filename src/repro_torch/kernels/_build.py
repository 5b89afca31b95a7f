"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file under ``repro_torch/kernels`` compiles, at first
use, into one shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source, its directory's headers, the
shared headers under ``common/csrc/`` and the flags, so a changed source rebuilds and an unchanged one loads as it is.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them.  ``nvcc`` comes from ``$CUDA_HOME/bin``, else ``PATH``, else the
CUDA home PyTorch found; a missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
#: headers shared by sources of several kernels
COMMON = _KERNELS / "common" / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}
#: ``ptxas -v`` report per built source (registers, spills), for the record
build_logs: dict[str, str] = {}
#: seconds from the start of :func:`build_all` to each source's build end
build_seconds: dict[str, float] = {}


def sources() -> list[Path]:
    """Every CUDA source of the package."""
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME:
        nvcc = Path(cpp_extension.CUDA_HOME) / "bin" / "nvcc"
        if nvcc.exists():
            return str(nvcc)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of repro_torch are built from source at first use")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for f in [src, *sorted(src.parent.glob("*.cuh")),
              *sorted(COMMON.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def _start(src: Path, out: Path):
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    # the compiler's report goes to a file: a full pipe would stall it
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                text=True)
    return proc, tmp, cmd


def build_all(srcs=None) -> dict[Path, Path]:
    """Build every source that has no current library, all ``nvcc``
    processes at once; returns ``{source: library}``."""
    srcs = list(srcs) if srcs is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src: _lib_path(src) for src in srcs}
    t0 = time.perf_counter()
    running = [(src, *_start(src, out)) for src, out in libs.items()
               if not out.exists()]
    failed = []
    while running:
        done = [r for r in running if r[1].poll() is not None]
        if not done:
            time.sleep(0.05)
            continue
        for src, proc, tmp, cmd in done:
            running.remove((src, proc, tmp, cmd))
            build_seconds[src.name] = time.perf_counter() - t0
            log_path = tmp.with_suffix(".log")
            build_logs[src.name] = log = log_path.read_text()
            log_path.unlink()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, libs[src])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""
    with _lock:
        lib = _loaded.get(src)
        if lib is None:
            path = build_all([src])[src]
            lib = _loaded[src] = ctypes.CDLL(str(path))
        return lib
