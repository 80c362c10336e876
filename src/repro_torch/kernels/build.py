"""Build the CUDA kernels of ``repro_torch/csrc`` and load them.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  The library is built at first use
into ``build/repro_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Each source is compiled by its own ``nvcc``
process, all started together, then linked once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    ``PATH``, else the toolkit's default install location."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the built library for the current sources (not built)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library if it is not built yet; returns its
    path.  The compiler's register and shared-memory report
    (``-Xptxas -v``) is kept beside it as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in procs), "-o",
             str(staged)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(log))
        os.replace(staged, lib)       # atomic: a concurrent loader sees
    return lib                        # either no library or a whole one


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures (pointers and the stream as ``c_void_p``, sizes as
    ``c_int``; every entry point returns a ``cudaError_t``)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_paged_decode_attention.argtypes = \
        [p] * 6 + [i] * 7 + [p, i, p, p, p]
    lib.repro_paged_decode_attention.restype = i
    lib.repro_paged_prefix_prefill_attention.argtypes = \
        [p] * 9 + [i] * 8 + [p]
    lib.repro_paged_prefix_prefill_attention.restype = i
    lib.repro_flash_attention.argtypes = [p] * 5 + [i] * 10 + [p]
    lib.repro_flash_attention.restype = i
    lib.repro_flash_attention_bwd.argtypes = [p] * 10 + [i] * 10 + [p]
    lib.repro_flash_attention_bwd.restype = i
    lib.repro_decode_attention.argtypes = \
        [p] * 5 + [i] * 6 + [p, i, p, p, p]
    lib.repro_decode_attention.restype = i
    lib.repro_decode_attention_int8.argtypes = \
        [p] * 7 + [i] * 6 + [p, i, p, p, p]
    lib.repro_decode_attention_int8.restype = i
    lib.repro_decode_attention_partial.argtypes = \
        [p] * 7 + [i] * 6 + [p, i, p, p, p]
    lib.repro_decode_attention_partial.restype = i
    lib.repro_decode_attention_int8_partial.argtypes = \
        [p] * 9 + [i] * 6 + [p, i, p, p, p]
    lib.repro_decode_attention_int8_partial.restype = i
    lib.repro_ssd_scan.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.repro_ssd_scan.restype = i
    lib.repro_ssd_scan_bwd.argtypes = [p] * 19 + [i] * 7 + [p]
    lib.repro_ssd_scan_bwd.restype = i
    return lib
