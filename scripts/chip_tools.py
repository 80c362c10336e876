"""What the card scripts share.

- :func:`use_tree`: make ``import repro_torch`` load another checkout's
  package, so that one process can time several trees of the
  repository (``sync_compare.py``, ``eager_step_compare.py``,
  ``ssd_scan_bwd_compare.py``).
- :func:`build_instrumented`: compile a copy of one of the port's CUDA
  sources with ``clock64`` marks into a library of its own, declared as
  the port declares it (``build.load_library()``'s argtypes), with
  :data:`N_COUNTERS` device counters that :func:`mark` and :func:`tally`
  lines add to (``ssd_scan_phases.py``, ``ssd_scan_bwd_phases.py``).

Imports no ``repro_torch`` module at import time: a compare script
picks its tree first.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import List

N_COUNTERS = 64
_COUNTERS = f"""__device__ unsigned long long phase_clk[{N_COUNTERS}];
extern "C" int phase_read(unsigned long long* h) {{
  return cudaMemcpyFromSymbol(h, phase_clk, sizeof(phase_clk));
}}
extern "C" int phase_zero() {{
  unsigned long long z[{N_COUNTERS}] = {{}};
  return cudaMemcpyToSymbol(phase_clk, z, sizeof(z));
}}
"""
# the line that starts a block's clock, before its first mark
START = "  long long clk = clock64();"


def use_tree(tree: str) -> None:
    """Make ``import repro_torch`` load ``tree``'s package: drop every
    ``repro_torch`` module and put ``tree/src`` first on the path, in
    place of any other ``src``."""
    for name in list(sys.modules):
        if name == "repro_torch" or name.startswith("repro_torch."):
            del sys.modules[name]
    src = os.path.join(os.path.abspath(tree), "src")
    sys.path[:] = [p for p in sys.path
                   if not p.endswith(os.sep + "src")] + [src]
    sys.path.insert(0, src)


def mark(slot: int) -> str:
    """A line that adds block thread 0's clocks since the last mark (or
    :data:`START`) to counter ``slot``."""
    return (f"    if (threadIdx.x == 0) {{ const long long now = clock64(); "
            f"atomicAdd(&phase_clk[{slot}], (unsigned long long)(now - "
            f"clk)); clk = now; }}")


def tally(slot: int) -> str:
    """A line that adds one to counter ``slot`` (thread 0, once each
    time the block passes it): blocks or loop turns, counted as run."""
    return (f"    if (threadIdx.x == 0) atomicAdd(&phase_clk[{slot}], "
            f"1ull);")


def build_instrumented(source: str, text: str, out: Path) -> ctypes.CDLL:
    """Compile ``text``, an instrumented copy of ``csrc/<source>``, with
    the port's nvcc flags into ``out`` beside copies of the port's
    headers, and load it: each entry point it defines takes the argtypes
    and restype that ``build.load_library()`` declares for it, and
    ``phase_read`` / ``phase_zero`` read and zero the counters."""
    from repro_torch.kernels import build
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    if "namespace repro {" not in text:
        raise RuntimeError(f"{source}: no `namespace repro {{` to put the "
                           f"counters before")
    (out / source).write_text(text.replace(
        "namespace repro {", _COUNTERS + "namespace repro {", 1))
    so = out / f"lib{Path(source).stem}_phases.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(out / source)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib, port = ctypes.CDLL(str(so)), build.load_library()
    for name in re.findall(r'extern "C" int (\w+)\(', text):
        declared = getattr(port, name, None)
        if declared is not None and declared.argtypes is not None:
            getattr(lib, name).argtypes = declared.argtypes
            getattr(lib, name).restype = declared.restype
    return lib


def zero_counters(lib: ctypes.CDLL) -> None:
    if lib.phase_zero():
        raise RuntimeError("phase_zero failed")


def read_counters(lib: ctypes.CDLL) -> List[int]:
    clk = (ctypes.c_ulonglong * N_COUNTERS)()
    if lib.phase_read(clk):
        raise RuntimeError("phase_read failed")
    return list(clk)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
