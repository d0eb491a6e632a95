"""The TFRecord reader/writer and CRC-32C in C++ (counterpart of
``hemx.native``), compiled from ``tfrecord.cc`` with g++ at first use.

:func:`load` returns the extension module with ``crc32c``,
``masked_crc32c``, ``read_all_records(path, verify=False)``,
``count_records`` and ``write_records``. The build goes into
``hemx_torch/_build/native/`` (or ``build_dir``), from the source in this
package only, through :func:`hemx_torch.utils.build.build_so`: the
``.so`` is named by a hash of the source and the compile line and built
once under a lock. There is no fallback: a build or load that fails
raises ``RuntimeError`` with the compiler's command and its stderr (a
missing ``g++`` or missing Python headers among them).
"""

from __future__ import annotations

import importlib.util
import os
import sysconfig

from hemx_torch.utils import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "tfrecord.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SOURCE)), "_build",
                         "native")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# The module name's last part must stay "_native" (PyInit__native); the
# whole name differs from hemx's "hemx.data._native", so both load in one
# process.
MODULE = "hemx_torch.native._native"
SUFFIX = sysconfig.get_config_var("EXT_SUFFIX")

_loaded: dict = {}  # build directory -> module


def compile_command() -> list[str]:
    """g++ and its flags, without the source and the output."""
    return ["g++", *FLAGS, f"-I{sysconfig.get_paths()['include']}"]


def so_path(build_dir: str | None = None) -> str:
    """Where the build of this source with :func:`compile_command` lies."""
    return build.so_path([SOURCE], compile_command(), build_dir or BUILD_DIR,
                         "_native", SUFFIX)


def load(build_dir: str | None = None):
    """The extension module, built into ``build_dir`` (default
    ``hemx_torch/_build/native``) at first use; raises ``RuntimeError`` if
    it cannot be built or loaded, never returns None."""
    key = BUILD_DIR if build_dir is None else os.path.abspath(build_dir)
    mod = _loaded.get(key)
    if mod is None:
        path = build.build_so([SOURCE], compile_command(), key, "_native",
                              SUFFIX)
        try:
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
        _loaded[key] = mod
    return mod
