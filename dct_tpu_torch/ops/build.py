"""Build the port's CUDA kernels at first use, from the repository's sources.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/dct_tpu_torch/`` at the repository root (``.gitignore`` lists
``build/`` and ``*.so``) and loaded with :mod:`ctypes`. The library's name
carries a hash of its source, so an edited kernel is rebuilt and a stale
library is never loaded. nvcc's output (with ptxas's registers, shared
memory and spills per kernel) is kept beside the library as
``lib<name>-<hash>.log``. A failed build raises with that output attached.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "dct_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc refused a kernel source; the message carries its output."""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"log": nvcc's output from the library's build, "path": the
#: library, "built": whether this process compiled it}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError("nvcc not found (put it on PATH or set CUDA_HOME)")


def load_kernel(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, load it
    and return the handle. Thread-safe; a process loads each library once.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(_CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        os.makedirs(BUILD_DIR, exist_ok=True)
        stem = os.path.join(BUILD_DIR, f"lib{name}-{digest}")
        out, log_path = f"{stem}.so", f"{stem}.log"
        built = not (os.path.exists(out) and os.path.exists(log_path))
        if built:
            tmp = f"{out}.tmp.{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}) building {src}:\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            # The log first: a library with its log beside it is complete.
            tmp_log = f"{log_path}.tmp.{os.getpid()}"
            with open(tmp_log, "w") as f:
                f.write(log)
            os.replace(tmp_log, log_path)
            os.replace(tmp, out)
        else:
            with open(log_path) as f:
                log = f.read()
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        build_info[name] = {"log": log, "path": out, "built": built}
        return lib
