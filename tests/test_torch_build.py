"""The port's kernel build: the library name covers every source it is
built from (CPU; no ``nvcc`` needed, nothing is compiled)."""

import shutil
import subprocess

from dct_tpu_torch.ops import build


def _write(path, text):
    path.write_text(text)
    return path


def test_library_name_covers_included_headers(tmp_path):
    _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\n')
    a = _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n')
    b = _write(tmp_path / "b.cuh", "// b\n")
    other = _write(tmp_path / "other.cuh", "// included by nothing\n")
    names = [build.library_stem("k", csrc=str(tmp_path))]
    _write(other, "// still included by nothing\n")
    assert build.library_stem("k", csrc=str(tmp_path)) == names[0]
    for path, text in ((b, "// b, edited\n"),  # through a.cuh
                       (a, '#pragma once\n#include "b.cuh"\n// a, edited\n'),
                       (tmp_path / "k.cu", '#include "a.cuh"\n')):
        _write(path, text)
        names.append(build.library_stem("k", csrc=str(tmp_path)))
    assert len(set(names)) == len(names)
    assert all(n.startswith(build.BUILD_DIR) for n in names)


def test_edited_sm90_header_renames_both_kernel_libraries(tmp_path):
    """Both kernel sources include csrc/sm90.cuh: an edit of the header
    alone must give each library a new name, so no stale build loads."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build._CSRC, csrc)
    before = {n: build.library_stem(n, csrc=str(csrc))
              for n in ("flash_fwd", "flash_bwd")}
    assert before == {n: build.library_stem(n) for n in before}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_stem(n, csrc=str(csrc)) for n in before}
    assert all(after[n] != before[n] for n in before)


def test_library_name_covers_flags_and_toolkit(tmp_path, monkeypatch):
    """A changed nvcc flag or compiler gives the library a new name, so a
    library built by another toolchain is never loaded."""
    _write(tmp_path / "k.cu", "// k\n")
    base = build.library_stem("k", csrc=str(tmp_path), toolkit="nvcc 12.8")
    assert build.library_stem("k", csrc=str(tmp_path),
                              toolkit="nvcc 12.8") == base
    assert build.library_stem("k", csrc=str(tmp_path),
                              toolkit="nvcc 12.9") != base
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_stem("k", csrc=str(tmp_path),
                              toolkit="nvcc 12.8") != base


def test_toolkit_version_is_read_once_and_only_when_loading(monkeypatch):
    """The CPU never asks for nvcc: the version is read at the first
    load of a library, once per process."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="nvcc fake\n")

    monkeypatch.setattr(build, "_toolkit", None)
    monkeypatch.setattr(build, "_cuda_tool", lambda tool: f"/x/{tool}")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    assert calls == []
    assert build.toolkit_version() == build.toolkit_version() == "nvcc fake\n"
    assert calls == [["/x/nvcc", "--version"]]
