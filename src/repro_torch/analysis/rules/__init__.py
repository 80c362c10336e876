"""hotlint rule modules of the port; each exposes
``check(project) -> List[Finding]``."""
from repro_torch.analysis.rules import ctypes_abi, graph_state, host_sync

ALL_RULES = (host_sync, graph_state, ctypes_abi)

__all__ = ["ALL_RULES", "ctypes_abi", "graph_state", "host_sync"]
