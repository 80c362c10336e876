"""Where the SSD scan backward's kernels spend their time, barrier by
barrier, on the card.

    PYTHONPATH=src python scripts/ssd_scan_bwd_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan_bwd.cu`` into
``build/ssd_scan_bwd_phases/`` with a ``clock64`` mark after each barrier
of ``ssd_bwd_chunk_kernel``'s loop over its heads and of
``ssd_bwd_bc_kernel``'s loop over the heads and its intra term (thread 0
of each block adds the clocks since the last mark to one counter per
phase, and counts the blocks and the heads they take), runs it at
mamba2-780m's and hymba-1.5b's training calls (B 8, S 256, chunk 128; H
48, N 128 and H 25, N 16) on the forward kernel's chunk states and C.B^T
scratch, and prints each kernel's phases' shares of its thread 0 clocks,
the clocks a head takes in the chunk kernel and a block takes in the bc
kernel, and the three CUDA kernels' device ms (``torch.profiler``).  A
phase is named by the comment on the barrier that ends it (or the line
before it); its share is wall time between barriers, the block's slowest
warp included.  Needs a CUDA card and nvcc."""
from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

import chip_tools
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import kernel

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ssd_scan_bwd_phases"
CALLS = [("mamba2-780m", 8, 256, 48, 64, 128, 128),
         ("hymba-1.5b", 8, 256, 25, 64, 16, 128)]
# (kernel, the line its region starts after, the text that ends it, the
# first counter); a kernel's last two counters count its blocks and the
# turns of its loop over the heads
REGIONS = [("ssd_bwd_chunk_kernel(", "for (int h = h0; h < h1; ++h) {",
            "the group's dG^T", 0),
           ("ssd_bwd_bc_kernel(", "for (int h = 0; h < H; ++h) {",
            "float* out = dc_out ? dc : db;", 32)]
SPAN = 32


def instrumented_source():
    """The source with the marks, and each kernel's phases' names."""
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text().split("\n")
    before, after, names = {}, {}, {}
    for kern, begin, stop, base in REGIONS:
        start = next(i for i, l in enumerate(src) if l.startswith(kern))
        loop = next(i for i in range(start, len(src)) if begin in src[i])
        end = next(i for i in range(loop, len(src)) if stop in src[i])
        names[kern] = []
        before[loop] = [chip_tools.START,
                        chip_tools.tally(base + SPAN - 2)]
        after[loop] = [chip_tools.tally(base + SPAN - 1)]
        for i in range(loop + 1, end):
            stripped = src[i].strip()
            if (stripped.startswith("__syncthreads();")
                    or stripped.startswith("staged();")):
                note = (stripped.split("//", 1)[1].strip() if "//" in
                        stripped else src[i - 1].strip().lstrip("/ ")[:40])
                after[i] = [chip_tools.mark(base + len(names[kern]))]
                names[kern].append(note)
        before[end] = [chip_tools.mark(base + len(names[kern]))]
        names[kern].append("to the end")
        if len(names[kern]) > SPAN - 2:
            raise RuntimeError(f"{kern} has more phases than counters")
    out = []
    for i, line in enumerate(src):
        out += before.get(i, []) + [line] + after.get(i, [])
    return "\n".join(out), names


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_scan_bwd_phases: needs a CUDA card", file=sys.stderr)
        return 2
    text, names = instrumented_source()
    lib = chip_tools.build_instrumented("ssd_scan_bwd.cu", text, OUT)
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(chip_tools.card())
    for arch, b, s, h, p, n, chunk in CALLS:
        f = dict(device="cuda", generator=gen)
        x, dy = torch.randn(b, s, h, p, **f), torch.randn(b, s, h, p, **f)
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, **f))
        a = -torch.exp(torch.randn(h, **f))
        bm, cm = torch.randn(b, s, n, **f), torch.randn(b, s, n, **f)
        cb = torch.empty(kernel.scratch_shape(b, s, chunk), device="cuda")
        _, _, states = kernel.ssd_scan_kernel(x, dt, a, bm, cm, chunk=chunk,
                                              scratch=cb, with_states=True)
        nc = states.shape[1]
        group = kernel.head_group_for(b, nc, h, sms)
        outs = [torch.empty_like(t) for t in (x, dt)] + [
            torch.empty(h, device="cuda")] + [torch.empty_like(bm)
                                              for _ in range(2)]
        scratch = [torch.empty(sh, device="cuda") for sh in
                   kernel.bwd_scratch_shapes(b, s, h, p, n, chunk, group)]

        def call():
            rc = lib.repro_ssd_scan_bwd(
                *(t.data_ptr() for t in (x, dt, a, bm, cm, dy, states, cb)),
                None, *(t.data_ptr() for t in outs + scratch),
                b, s, h, p, n, chunk, group,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        call()
        chip_tools.zero_counters(lib)
        call()
        torch.cuda.synchronize()
        clk = chip_tools.read_counters(lib)
        parts = []
        for kern, _, _, base in REGIONS:
            phases = names[kern]
            total = sum(clk[base:base + len(phases)])
            blocks, heads = clk[base + SPAN - 2], clk[base + SPAN - 1]
            parts.append(
                f"{kern[:-1]} {total / blocks:.0f} clocks a block of "
                f"{blocks}, {total / heads:.0f} a head: "
                + ", ".join(f"{nm} {clk[base + i] / total:.3f}"
                            for i, nm in enumerate(phases)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        times = {re.search(r"ssd_bwd_\w+", e.key).group(0):
                 e.device_time_total / e.count / 1e3
                 for e in prof.key_averages() if "ssd_bwd" in e.key}
        print(f"{arch} (B {b}, H {h}, N {n}, group {group}): "
              + "; ".join(parts) + "; device ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
