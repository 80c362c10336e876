"""Seeded violation: a suppressed sync with no host_syncs increment.

Parsed by the port's hotlint in tests — never imported.  The readback
carries a counted ``# hotlint: sync(...)`` suppression (so HL001 stays
quiet) but no ``host_syncs`` increment follows within the audit window:
HL005 must fire.
"""
import torch

from repro_torch.analysis.sanitizer import hot_path


@hot_path
def step_loop(state, logits: torch.Tensor):
    tok = torch.argmax(logits, dim=-1)
    # hotlint: sync(window readback)
    out = tok.cpu().numpy()
    state["tokens"].append(out)
    return state
