"""Build and load the package's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` for sm_90a into ``csrc/build/lib<name>_<hash>.so`` (the
hash is the source's, so an edited source builds anew) and loaded with
``ctypes``. Builds happen at first use, never at import: the CPU tests import
every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); it is "
                       "needed to build the kernels in csrc/")


def library_path(name, flags=()):
    """Where ``csrc/<name>.cu`` builds to, keyed by the hash of the source
    and of any extra ``nvcc`` flags."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(*names, flags=()):
    """Compile every named source that has no library yet, one ``nvcc``
    process each, all started together. ``flags``: extra ``nvcc`` flags (a
    profiling build's ``-D``), which give the library a name of its own."""
    jobs = []
    for name in names:
        lib = library_path(name, flags)
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               *flags, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                          f"{out}\n{err}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.lru_cache(maxsize=None)
def load_library(name, flags=()):
    """Build ``csrc/<name>.cu`` if needed and return the loaded CDLL."""
    build(name, flags=flags)
    return ctypes.CDLL(library_path(name, flags))
