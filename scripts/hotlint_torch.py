#!/usr/bin/env python
"""Static hot-path lint CLI for the PyTorch port (DESIGN.md §13).

    python scripts/hotlint_torch.py src/repro_torch
    python scripts/hotlint_torch.py src/repro_torch \\
        --baseline scripts/hotlint_torch_baseline.txt

Exit 0 when every finding is in the baseline (or there are none); exit 1
and print each new finding otherwise.  Pure stdlib: parses the tree (and
reads the CUDA sources as text), never imports it.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.analysis import hotlint  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="files, or package roots (serving/models/kernels "
                         "subtrees are walked, csrc/*.cu read)")
    ap.add_argument("--baseline", default=None,
                    help="grandfathered-findings file; new findings only "
                         "fail the run")
    args = ap.parse_args(argv)

    findings = hotlint.lint(args.paths)
    baseline = hotlint.load_baseline(args.baseline)
    new = [f for f in findings if f.baseline_key() not in baseline]
    old = len(findings) - len(new)
    for f in new:
        print(f.render())
    suffix = f" ({old} baselined)" if old else ""
    print(f"hotlint: {len(new)} new finding(s){suffix} in "
          f"{len(args.paths)} path(s)")
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
