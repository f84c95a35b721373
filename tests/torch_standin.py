"""The card stood in for on the CPU, for tests of the port's graphed path
(tests/test_torch_inspector.py, test_torch_dynamics.py,
test_torch_telemetry_export.py, test_torch_smoke_observe.py): the graph
gate answers as for a CUDA place, and a capture is a stand-in that runs
nothing when it captures and its body at each replay (a real capture
launches nothing, and a table a sparse apply updates in place would
otherwise advance twice). Counts its captures."""

import torch

from paddle_tpu_torch import executor as E


class Replayed:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()

    def pool(self):
        return None


def graphed(monkeypatch):
    """Patch the executor for the graphed path on the CPU; returns the list
    the stand-in appends each capture to."""
    captures = []

    def capture(body, pool=None, keep=False, generators=()):
        g = Replayed(body)
        captures.append(g)
        return g

    monkeypatch.setattr(E, "capture_graph", capture)
    gate = E.Executor.graph_gate

    def as_on_a_card(self, program, feed, use_jit=None,
                     use_program_cache=True):
        dev, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = dev

    monkeypatch.setattr(E.Executor, "graph_gate", as_on_a_card)
    return captures
