"""Build the port's CUDA kernels at first use, from the repository's sources.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/dct_tpu_torch/`` at the repository root (``.gitignore`` lists
``build/`` and ``*.so``) and loaded with :mod:`ctypes`. The library's name
carries a hash of its source, so an edited kernel is rebuilt and a stale
library is never loaded; the hash covers the ``csrc/*.cuh`` headers the
source includes (``#include "name.cuh"``, followed through headers that
include others), so an edited header rebuilds every library that includes
it. nvcc's output (with ptxas's registers, shared
memory and spills per kernel) is kept beside the library as
``lib<name>-<hash>.log``. A failed build raises with that output attached.
:func:`load_kernels` starts one ``nvcc`` per missing library, all at once,
so a process that needs every kernel waits for the slowest build only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def _cuda_tool(tool: str) -> str:
    found = shutil.which(tool)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", tool)):
        return os.path.join(CUDA_HOME, "bin", tool)
    raise KernelBuildError(
        f"{tool} not found (put it on PATH or set CUDA_HOME)"
    )


def sass(name: str) -> str:
    """``cuobjdump -sass`` of a loaded kernel library: the machine code of
    every kernel instance in it, each under a ``Function : <mangled name>``
    line."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                          build_info[name]["path"]],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return out.stdout


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def source_digest(src: str) -> str:
    """Hash of a kernel source and every header of its directory that it
    includes, directly or through another header (12 hex digits)."""
    h = hashlib.sha1()
    todo, seen = [src], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b"\0" + text + b"\0")
        todo.extend(os.path.join(os.path.dirname(src), inc.decode())
                    for inc in _INCLUDE.findall(text))
    return h.hexdigest()[:12]


def library_stem(name: str, csrc: str = _CSRC) -> str:
    """``build/dct_tpu_torch/lib<name>-<digest>`` for ``csrc/<name>.cu``."""
    digest = source_digest(os.path.join(csrc, f"{name}.cu"))
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}")


def load_kernel(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, load it
    and return the handle. Thread-safe; a process loads each library once.
    """
    return load_kernels(name)[name]


def load_kernels(*names: str) -> dict[str, ctypes.CDLL]:
    """:func:`load_kernel` for several kernels, their builds run in
    parallel (one ``nvcc`` per source)."""
    with _lock:
        todo = {}
        for name in names:
            if name in _libs or name in todo:
                continue
            src = os.path.join(_CSRC, f"{name}.cu")
            os.makedirs(BUILD_DIR, exist_ok=True)
            stem = library_stem(name)
            todo[name] = (src, f"{stem}.so", f"{stem}.log")
        procs = {}
        for name, (src, out, log_path) in todo.items():
            if not (os.path.exists(out) and os.path.exists(log_path)):
                cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o",
                       f"{out}.tmp.{os.getpid()}", src]
                procs[name] = (cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
        logs = {name: (cmd, proc.communicate()[0], proc.returncode)
                for name, (cmd, proc) in procs.items()}
        for name, (src, out, log_path) in todo.items():
            if name in logs:
                cmd, log, rc = logs[name]
                if rc != 0:
                    raise KernelBuildError(
                        f"nvcc failed ({rc}) building {src}:\n"
                        f"{' '.join(cmd)}\n{log}"
                    )
                # The log first: a library with its log beside it is
                # complete.
                tmp_log = f"{log_path}.tmp.{os.getpid()}"
                with open(tmp_log, "w") as f:
                    f.write(log)
                os.replace(tmp_log, log_path)
                os.replace(f"{out}.tmp.{os.getpid()}", out)
            else:
                with open(log_path) as f:
                    log = f.read()
            _libs[name] = ctypes.CDLL(out)
            build_info[name] = {"log": log, "path": out,
                                "built": name in logs}
        return {name: _libs[name] for name in names}
