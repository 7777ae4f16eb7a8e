"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface.  It is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``)
and loaded with ``ctypes``; no PyTorch header is compiled, so a build
takes seconds.  A library is named by a digest of its source and flags,
so an edited source builds anew and an unchanged one is reused.  The
sources come from this package alone; a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_mu = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler, or raise."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` process each, all started together.  Returns
    ``{name: library path}``; the compiler's report (registers, spills)
    is kept beside each library as ``<library>.log``."""
    srcs = sorted(CSRC.glob("*.cu")) if names is None \
        else [CSRC / f"{name}.cu" for name in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for src in srcs:
        lib = library_path(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        lib.with_name(lib.name + ".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _mu:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
        return _libs[name]
