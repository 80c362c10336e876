"""Seeded violation: an unsuppressed ``.item()`` readback in a hot loop.

Parsed by the port's hotlint in tests — never imported.  ``tok[0].item()``
reads a device value back inside a hot function with no
``# hotlint: sync(...)`` suppression, so HL001 must fire.
"""
import torch

from repro_torch.analysis.sanitizer import hot_path


@hot_path
def step_loop(logits: torch.Tensor) -> int:
    tok = torch.argmax(logits, dim=-1)
    return tok[0].item()
