"""PyTorch port, ``cuda_build``: what decides that a kernel library is
rebuilt, and the nvcc command, without nvcc.

A source's build is named by a digest of the source, every ``csrc/*.cuh``
header and the flags, so an edited header rebuilds the sources that may
include it. ``SRC_DIR`` and ``BUILD_DIR`` are pointed at a temporary
directory, and nvcc is replaced by a stand-in that records its command and
writes the output file.
"""

from pathlib import Path

import pytest

from flexflow_tpu_torch import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\nint f() { return g(); }\n')
    (src / "common.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(cuda_build, "SRC_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    return src


def _lib():
    return cuda_build._paths("k")[1].name


def _fake_nvcc(monkeypatch, calls):
    """nvcc stand-in: records each command and writes its output file."""

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return type("P", (), dict(returncode=0, stdout="ptxas info\n",
                                  stderr=""))()

    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "/x/nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)


def test_digest_changes_when_only_the_header_changes(csrc):
    before = _lib()
    (csrc / "common.cuh").write_text("inline int g() { return 2; }\n")
    after = _lib()
    assert before != after and after.startswith("libk-")
    (csrc / "common.cuh").write_text("inline int g() { return 1; }\n")
    assert _lib() == before  # the same bytes give the same build


def test_digest_changes_when_a_header_is_added(csrc):
    before = _lib()
    (csrc / "other.cuh").write_text("// another header\n")
    assert _lib() != before


def test_digest_changes_with_the_source(csrc):
    before = _lib()
    (csrc / "k.cu").write_text('#include "common.cuh"\nint f() { return 0; }\n')
    assert _lib() != before


def test_digest_changes_with_the_flags(csrc, monkeypatch):
    before = _lib()
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        (*cuda_build.NVCC_FLAGS, "-lineinfo"))
    assert _lib() != before


def test_nvcc_command_names_csrc(csrc, monkeypatch):
    calls = []
    _fake_nvcc(monkeypatch, calls)
    cuda_build.build("k")
    (cmd,) = calls
    assert cmd[0] == "/x/nvcc"
    assert f"-I{csrc}" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-3] == "-o" and cmd[-1] == str(csrc / "k.cu")


def test_build_runs_nvcc_once_per_digest(csrc, monkeypatch):
    """A build that exists is not rebuilt; an edited header rebuilds; nvcc's
    output is kept as the build's log."""
    calls = []
    _fake_nvcc(monkeypatch, calls)
    first = cuda_build.build("k")
    assert cuda_build.build("k") == first and len(calls) == 1
    assert cuda_build.build_log("k") == "ptxas info\n"
    (csrc / "common.cuh").write_text("inline int g() { return 3; }\n")
    assert cuda_build.build("k") != first and len(calls) == 2


def test_failed_build_raises_with_nvcc_errors(csrc, monkeypatch):
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(
        cuda_build.subprocess, "run",
        lambda cmd, capture_output, text: type(
            "P", (), dict(returncode=2, stdout="", stderr="bad wgmma"))())
    with pytest.raises(RuntimeError, match="bad wgmma"):
        cuda_build.build("k")
    assert not cuda_build._paths("k")[1].exists()
