"""Build a shared library from the package's own sources, once, under a lock.

Used by the g++ build of ``hemx_torch.native`` and the nvcc build of the
CUDA kernels (``hemx_torch.ops.input_kernels``). :func:`build_so`:

* names the library by a hash of the sources and the compile line, so a
  stale or foreign build is never loaded;
* holds an ``fcntl.flock`` on ``<build_dir>/lock``, checks again for the
  library once it has the lock, compiles to a temporary name in the same
  directory and moves the result into place with ``os.replace``: workers
  or ranks that start together build once, and none loads a half-written
  file;
* raises ``RuntimeError`` with the command and the compiler's stderr when
  the compiler is missing or fails: there is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess


def so_path(sources, command, build_dir: str, stem: str, suffix: str) -> str:
    """Where the build of ``sources`` by ``command`` lies in ``build_dir``:
    ``<stem>.<hash><suffix>``, the hash of the sources' bytes and the
    command."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(command).encode())
    return os.path.join(build_dir, f"{stem}.{h.hexdigest()[:16]}{suffix}")


def log_path(path: str) -> str:
    """The compiler's output of the build at ``path`` (kept with ``log``)."""
    return f"{path}.log"


def build_so(sources, command, build_dir: str, stem: str, suffix: str, *,
             log: bool = False, timeout: float = 300) -> str:
    """The path of the library built from ``sources`` by ``command`` (the
    compiler and its flags, without sources and output), compiled first
    unless it is there. With ``log`` the compiler's stdout and stderr are
    kept beside it (:func:`log_path`)."""
    path = so_path(sources, command, build_dir, stem, suffix)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"  # one compiler at a time
        tmp_log = f"{tmp}.log"
        cmd = list(command) + list(sources) + ["-o", tmp]
        what = " ".join(os.path.basename(s) for s in sources)
        try:
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"building {what} failed: "
                                   f"{' '.join(cmd)}: {e}") from e
            if r.returncode != 0:
                raise RuntimeError(f"building {what} failed (exit "
                                   f"{r.returncode}): {' '.join(cmd)}\n"
                                   f"{r.stderr}{r.stdout}")
            if log:
                with open(tmp_log, "w") as f:
                    f.write(r.stdout + r.stderr)
                os.replace(tmp_log, log_path(path))
            os.replace(tmp, path)
        finally:
            for f in (tmp, tmp_log):
                if os.path.exists(f):
                    os.unlink(f)
    return path
