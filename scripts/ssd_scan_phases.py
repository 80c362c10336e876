"""Where the SSD scan kernel's time goes, phase by phase, on the card.

    PYTHONPATH=src python scripts/ssd_scan_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` into
``build/ssd_scan_phases/`` with a ``clock64`` mark after each barrier of
``ssd_scan_kernel`` (thread 0 adds the clocks since the last mark to one
counter per phase), runs it at mamba2-780m's widths (H 48, P 64, N 128,
chunk 128, S 256) for B 1, 4 and 20 at the P slice the wrapper picks,
and prints each phase's share of thread 0's clocks, a block's clocks,
and both CUDA kernels' device times (``torch.profiler``).  A phase's
share is wall time between barriers, the block's slowest warp included;
the other block on the SM runs meanwhile.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import kernel

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ssd_scan_phases"
# the phase that ends at each barrier of the scan kernel, in order
PHASES = ["(c) of the last chunk", "stage c and state", "cum scan",
          "(a) C.state^T", "stage x and G", "W", "(b) W.X and y",
          "stage b"]
COUNTERS = """__device__ unsigned long long phase_clk[16];
extern "C" int phase_read(unsigned long long* h) {
  return cudaMemcpyFromSymbol(h, phase_clk, sizeof(phase_clk));
}
extern "C" int phase_zero() {
  unsigned long long z[16] = {};
  return cudaMemcpyToSymbol(phase_clk, z, sizeof(z));
}
"""


def instrumented_source() -> str:
    src = (build.CSRC / "ssd_scan.cu").read_text().split("\n")
    start = next(i for i, l in enumerate(src) if l.startswith(
        "ssd_scan_kernel("))
    out, k = [], 0
    for i, line in enumerate(src):
        out.append(line)
        stripped = line.strip()
        if i > start and k < len(PHASES) and (
                stripped.startswith("__syncthreads();")
                or stripped == "staged();"):
            out.append(f"    if (tid == 0) {{ const long long now = "
                       f"clock64(); atomicAdd(&phase_clk[{k}], "
                       f"(unsigned long long)(now - clk)); clk = now; }}")
            k += 1
        if stripped.startswith("for (int z = 0; z < nc; ++z) {"):
            out.insert(len(out) - 1, "  long long clk = clock64();")
    if k != len(PHASES):
        raise RuntimeError(f"found {k} barriers, expected {len(PHASES)}")
    text = "\n".join(out)
    return text.replace("namespace repro {", COUNTERS + "namespace repro {",
                        1)


def load() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    for name in ("hopper_mma.cuh", "tf32_mma.cuh"):
        (OUT / name).write_text((build.CSRC / name).read_text())
    (OUT / "ssd_scan.cu").write_text(instrumented_source())
    so = OUT / "libphases.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(OUT / "ssd_scan.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd_scan.argtypes = [p] * 8 + [i] * 7 + [p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_phases: needs a CUDA card", file=sys.stderr)
        return 2
    lib = load()
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for b in (1, 4, 20):
        f = dict(device="cuda", generator=gen)
        x = torch.randn(b, 256, 48, 64, **f)
        dt = torch.nn.functional.softplus(torch.randn(b, 256, 48, **f))
        a = -torch.exp(torch.randn(48, **f))
        bm, cm = torch.randn(b, 256, 128, **f), torch.randn(b, 256, 128, **f)
        y = torch.empty_like(x)
        st = torch.empty(b, 48, 64, 128, device="cuda")
        scratch = torch.empty(kernel.scratch_shape(b, 256, 128),
                              device="cuda")
        pt = kernel.p_tile_for(b, 48, 64, sms)

        def call():
            rc = lib.repro_ssd_scan(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                cm.data_ptr(), y.data_ptr(), st.data_ptr(),
                scratch.data_ptr(), b, 256, 48, 64, 128, 128, pt,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        call()
        lib.phase_zero()
        call()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 16)()
        lib.phase_read(clk)
        total = sum(clk[:len(PHASES)])
        blocks = 48 * (64 // pt) * b
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        times = {re.search(r"ssd_\w+<[^>]*>", e.key).group(0):
                 e.device_time_total / e.count / 1e3
                 for e in prof.key_averages() if "ssd_" in e.key}
        print(f"B={b} P slice {pt}: {total / blocks:.0f} clocks a block; "
              + ", ".join(f"{n} {clk[i] / total:.3f}"
                          for i, n in enumerate(PHASES))
              + "; device ms " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
