"""Seeded violation: an index write of a Python value into device state.

Parsed by the port's hotlint in tests — never imported.  ``positions[slot]
= 0`` on a CUDA tensor copies the 0 from the host and waits for the
device (torch's sync detector reports it), so HL001 must fire; the
port's engines ``fill_`` instead.
"""
from repro_torch.analysis.sanitizer import hot_path


class Engine:
    _DEVICE_STATE = ("positions",)

    @hot_path
    def release(self, slot: int) -> None:
        self.positions[slot] = 0
