"""Seeded violation: a tensor a captured CUDA graph reads is rebound.

Parsed by the port's hotlint in tests — never imported.  ``Engine``
captures a graph over ``self.logits``; ``step`` then rebinds
``self.logits`` to a new tensor, so the graph replays on the old one:
HL002 must fire.
"""
import torch


class Graph:
    def __init__(self, state):
        self.state = state
        self.graph = torch.cuda.CUDAGraph()


class Engine:
    _DEVICE_STATE = ("logits",)

    def __init__(self, logits):
        self.logits = logits
        self.graph = None

    def capture(self):
        self.graph = Graph({"logits": self.logits})

    def step(self):
        self.logits = self.logits * 2
