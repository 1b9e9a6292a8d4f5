"""Build-and-cache helper for the host-side C++ libraries.

Each library is compiled on first use into a ``.so`` next to its source,
named by a hash of the source text, the compiler flags and the host
(``-march=native`` code built on one machine can crash another). A stale or
foreign build therefore never matches and is rebuilt, never loaded. The
build writes to a temporary name and renames it into place, so concurrent
processes never load a half-written file.
"""
from __future__ import annotations

import hashlib
import logging
import os
import platform
import subprocess
from pathlib import Path

log = logging.getLogger(__name__)


def build_key(src: Path, flags: list[str]) -> str:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update("\0".join(flags).encode())
    h.update("\0".join((platform.node(), platform.machine(),
                        platform.processor())).encode())
    return h.hexdigest()[:16]


def build_shared_lib(src: Path, flags: list[str]) -> Path | None:
    """Path of the ``.so`` built from ``src`` with ``g++ flags``, compiling
    it if this exact (source, flags, host) build is not there yet. Returns
    None (with a warning) when the compile fails."""
    so = src.with_name(f"_{src.stem}-{build_key(src, flags)}.so")
    if so.exists():
        return so
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except Exception as e:
        log.warning("native build of %s failed (%s)", src.name, e)
        tmp.unlink(missing_ok=True)
        return None
    return so
