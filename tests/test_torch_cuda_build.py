"""The nvcc build of hemx_torch's CUDA kernel, on the CPU (no nvcc, no card).

* The compile line targets ``sm_90a`` only and forbids multiply-add
  contraction, so the kernel rounds as its plain version does.
* The library's name is a hash of the source and the compile line.
* A build without ``nvcc`` raises ``RuntimeError`` naming the command and
  leaves no file but the lock; there is no fallback.
* CPU tensors take the plain version and never build or load anything.
* The port never imports Triton, and imports with none installed.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hemx_torch.ops import input_kernels as K  # noqa: E402
from hemx_torch.utils import build  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_compile_line_targets_sm90a_without_fma():
    cmd = K.compile_command()
    assert os.path.basename(cmd[0]) == "nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd.count("-gencode") == 1  # no other target
    assert "-fmad=false" in cmd
    for flag in ("-std=c++17", "-O3", "-shared"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"  # registers, smem, spills
    # the source itself rounds the product and the sum apart
    src = Path(K.SOURCE).read_text()
    assert "__fadd_rn(__fmul_rn(" in src
    assert "cp.async.bulk" in src and "mbarrier" in src


def test_so_name_follows_source_and_flags(tmp_path, monkeypatch):
    first = K.so_path(str(tmp_path))
    assert os.path.dirname(first) == str(tmp_path)
    assert re.fullmatch(r"gather_u8_normalize\.[0-9a-f]{16}\.so",
                        os.path.basename(first))
    assert K.so_path(str(tmp_path)) == first  # stable
    edited = tmp_path / "edited.cu"
    edited.write_bytes(Path(K.SOURCE).read_bytes() + b"\n")
    monkeypatch.setattr(K, "SOURCE", str(edited))
    by_source = K.so_path(str(tmp_path))
    monkeypatch.setattr(K, "FLAGS", K.FLAGS + ("-lineinfo",))
    by_flags = K.so_path(str(tmp_path))
    assert len({first, by_source, by_flags}) == 3
    assert K.so_path().startswith(K.BUILD_DIR + os.sep)


def test_build_without_nvcc_raises_naming_the_command(tmp_path, monkeypatch):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    assert shutil.which("nvcc") is None
    out = tmp_path / "build"
    with pytest.raises(RuntimeError) as e:
        K.build(str(out))
    msg = str(e.value)
    assert str(tmp_path / "no_cuda" / "bin" / "nvcc") in msg
    assert "arch=compute_90a,code=sm_90a" in msg and K.SOURCE in msg
    assert os.listdir(out) == ["lock"]  # no library, no temporary file


def test_failing_nvcc_raises_with_its_stderr(tmp_path, monkeypatch):
    """A compile error (here an nvcc that fails, first on PATH) raises with
    the compiler's stderr, through the build shared with the g++ one."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: identifier \"x\" is undefined' "
                    ">&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="exit 2") as e:
        K.build(str(out))
    assert 'identifier "x" is undefined' in str(e.value)
    assert str(fake) in str(e.value)
    assert os.listdir(out) == ["lock"]


def test_a_built_library_is_reused_with_its_log(tmp_path, monkeypatch):
    """A second build of the same source and command finds the library and
    runs no compiler; the compiler's output lies beside the library."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls"
    fake = bin_dir / "nvcc"
    # writes its -o argument and ptxas-like lines, counting its runs
    fake.write_text("#!/bin/sh\necho run >> '%s'\nwhile [ $# -gt 0 ]; do "
                    "if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi; shift; "
                    "done\necho 'ptxas info    : Used 32 registers' >&2\n"
                    % calls)
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    out = str(tmp_path / "build")
    path = K.build(out)
    assert K.build(out) == path == K.so_path(out)
    assert calls.read_text() == "run\n"
    with open(build.log_path(path)) as f:
        assert "Used 32 registers" in f.read()
    assert sorted(os.listdir(out)) == sorted(
        ["lock", os.path.basename(path), os.path.basename(path) + ".log"])


def test_cpu_tensors_never_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path built or loaded the kernel")
    monkeypatch.setattr(K, "_launcher", refuse)
    monkeypatch.setattr(build, "build_so", refuse)
    rng = np.random.default_rng(0)
    ds = torch.from_numpy(rng.integers(0, 256, (6, 5, 7, 3), dtype=np.uint8))
    for idx in (torch.tensor([4, 0, 5], dtype=torch.int32),
                torch.tensor([], dtype=torch.int64)):
        before = dict(K.LAUNCHES)
        got = K.gather_u8_normalize(ds, idx, -1.0, 1.0, rows=(1, 3))
        assert K.LAUNCHES == before
        assert torch.equal(got, K.gather_u8_normalize_ref(ds, idx, -1.0, 1.0,
                                                          rows=(1, 3)))


def test_port_never_imports_triton():
    """No source of the port, nor chip_smoke.py, imports Triton, and every
    module of the port imports in an interpreter where Triton cannot."""
    pat = re.compile(r"^\s*(import|from)\s+triton\b", re.M)
    for path in list((REPO / "hemx_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py", REPO / "scripts" / "trees_ab.py"]:
        assert not pat.search(path.read_text()), path
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['triton'] = None  # any import of it raises\n"
        "import hemx_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    hemx_torch.__path__, 'hemx_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import torch\n"
        "from hemx_torch.ops.input_kernels import gather_u8_normalize\n"
        "gather_u8_normalize(torch.zeros((2, 3, 3, 1), dtype=torch.uint8),\n"
        "                    torch.tensor([1, 0]))\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) > 50  # the whole package was walked
