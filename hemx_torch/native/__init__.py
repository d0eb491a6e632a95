"""The TFRecord reader/writer and CRC-32C in C++ (counterpart of
``hemx.native``), compiled from ``tfrecord.cc`` with g++ at first use.

:func:`load` returns the extension module with ``crc32c``,
``masked_crc32c``, ``read_all_records(path, verify=False)``,
``count_records`` and ``write_records``. The build:

* goes into ``hemx_torch/_build/native/`` (or ``build_dir``), from the
  source in this package only;
* names the ``.so`` by a hash of the source and the compile line, so a
  stale or foreign build is never loaded;
* holds an ``fcntl.flock`` on ``<build_dir>/lock``, checks again for the
  ``.so`` once it has the lock, compiles to a temporary name in the same
  directory and moves the result into place with ``os.replace``: workers
  or ranks that start together build once, and none loads a half-written
  file.

There is no fallback: a build or load that fails raises ``RuntimeError``
with the compiler's command and its stderr (a missing ``g++`` or missing
Python headers among them).
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sysconfig

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "tfrecord.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build",
                         "native")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# The module name's last part must stay "_native" (PyInit__native); the
# whole name differs from hemx's "hemx.data._native", so both load in one
# process.
MODULE = "hemx_torch.native._native"

_loaded: dict = {}  # build directory -> module


def compile_command() -> list[str]:
    """g++ and its flags, without the source and the output."""
    return ["g++", *FLAGS, f"-I{sysconfig.get_paths()['include']}"]


def so_path(build_dir: str | None = None) -> str:
    """Where the build of this source with :func:`compile_command` lies."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join(compile_command()).encode())
    return os.path.join(build_dir or BUILD_DIR,
                        f"_native.{h.hexdigest()[:16]}"
                        f"{sysconfig.get_config_var('EXT_SUFFIX')}")


def _build(build_dir: str) -> str:
    """The path of the ``.so``, compiled first unless it is there."""
    path = so_path(build_dir)
    if os.path.exists(path):
        return path
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"  # one compiler at a time
        cmd = compile_command() + [SOURCE, "-o", tmp]
        try:
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"building {SOURCE} failed: "
                                   f"{' '.join(cmd)}: {e}") from e
            if r.returncode != 0:
                raise RuntimeError(f"building {SOURCE} failed (exit "
                                   f"{r.returncode}): {' '.join(cmd)}\n"
                                   f"{r.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def load(build_dir: str | None = None):
    """The extension module, built into ``build_dir`` (default
    ``hemx_torch/_build/native``) at first use; raises ``RuntimeError`` if
    it cannot be built or loaded, never returns None."""
    key = BUILD_DIR if build_dir is None else os.path.abspath(build_dir)
    mod = _loaded.get(key)
    if mod is None:
        path = _build(key)
        try:
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        _loaded[key] = mod
    return mod
