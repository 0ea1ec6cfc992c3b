"""Build a shared library from the repo's sources at first use, safe when
several processes start at once.

`build_so(stem, sources, command)` returns the path of
`csrc/build/lib<stem>_<hash>.so`, where the hash covers each source's name
and bytes and the build flags. If no such file is there, `command(tmp)`
gives the command that writes the library into `tmp`, a new private
directory, and the file it writes there. The finished file is renamed whole
into place: a process never opens a half-written library, and two builders
of one source end with one file. A failed build raises RuntimeError with
the compiler's output. The scatter kernel (`ops/scatter.py`), the native
mesh library (`native.py`) and the JPEG decoder (`utils/jpeg.py`) are
built this way. The compiler's run is the span `build.<stem>`
(`utils/profiling.py`); a build found in place records none.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

from bundlesdf_tpu_torch.utils.profiling import span

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "build")


def library_path(stem, sources, flags=(), build_dir=BUILD_DIR) -> str:
    """Where the build of the current @sources with @flags lives."""
    h = hashlib.sha1()
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:12]}.so")


def build_so(stem, sources, command, flags=(), build_dir=BUILD_DIR
             ) -> tuple[str, str]:
    """Build `lib<stem>` unless a build of the same @sources and @flags is
    in @build_dir (see the module docstring). @command: callable(tmp) ->
    (argv, path of the library it writes). Returns (path, the compiler's
    output, empty when the library was there)."""
    path = library_path(stem, sources, flags, build_dir)
    if os.path.exists(path):
        return path, ""
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{stem}.", dir=build_dir)
    try:
        argv, out = command(tmp)
        with span(f"build.{stem}"):
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"building {stem} failed ({proc.returncode}):"
                               f" {' '.join(argv)}\n{log}")
        os.replace(out, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path, log
