"""Where the SSD scan kernel's time goes, phase by phase, on the card.

    PYTHONPATH=src python scripts/ssd_scan_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` into
``build/ssd_scan_phases/`` with a ``clock64`` mark after each barrier of
``ssd_scan_kernel`` (thread 0 adds the clocks since the last mark to one
counter per phase), runs it at mamba2-780m's widths (H 48, P 64, N 128,
chunk 128, S 256) for B 1, 4 and 20 at the P slice the wrapper picks,
and prints each phase's share of thread 0's clocks, a block's clocks
(the blocks counted as they run), and both CUDA kernels' device times (``torch.profiler``).  A phase's
share is wall time between barriers, the block's slowest warp included;
the other block on the SM runs meanwhile.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

import chip_tools
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import kernel

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ssd_scan_phases"
# the phase that ends at each barrier of the scan kernel, in order
PHASES = ["(c) of the last chunk", "stage c and state", "cum scan",
          "(a) C.state^T", "stage x and G", "W", "(b) W.X and y",
          "stage b"]
BLOCKS = len(PHASES)              # the counter of the blocks that ran


def instrumented_source() -> str:
    src = (build.CSRC / "ssd_scan.cu").read_text().split("\n")
    start = next(i for i, l in enumerate(src) if l.startswith(
        "ssd_scan_kernel("))
    out, k = [], 0
    for i, line in enumerate(src):
        stripped = line.strip()
        if i > start and stripped.startswith("for (int z = 0; z < nc; ++z) {"):
            out += [chip_tools.START, chip_tools.tally(BLOCKS)]
        out.append(line)
        if i > start and k < len(PHASES) and (
                stripped.startswith("__syncthreads();")
                or stripped == "staged();"):
            out.append(chip_tools.mark(k))
            k += 1
    if k != len(PHASES):
        raise RuntimeError(f"found {k} barriers, expected {len(PHASES)}")
    return "\n".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_phases: needs a CUDA card", file=sys.stderr)
        return 2
    lib = chip_tools.build_instrumented("ssd_scan.cu", instrumented_source(),
                                        OUT)
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(chip_tools.card())
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
                cm.data_ptr(), y.data_ptr(), st.data_ptr(), None,
                scratch.data_ptr(), b, 256, 48, 64, 128, 128, pt,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        call()
        chip_tools.zero_counters(lib)
        call()
        torch.cuda.synchronize()
        clk = chip_tools.read_counters(lib)
        total = sum(clk[:len(PHASES)])
        blocks = clk[BLOCKS]
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
