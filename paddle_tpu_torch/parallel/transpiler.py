"""DistributeTranspiler: the source-compatible facade over mesh sharding
(the port's counterpart of paddle_tpu/parallel/transpiler.py).

The reference rewrites the program into trainer and parameter-server
programs (distribute_transpiler.py:134 transpile, :258
get_pserver_program). Here, as in the JAX package, the tier collapses into
synchronous all-reduce data parallelism: `transpile` tags the program with
a 'dp' mesh over the process group's ranks, and the executor runs it SPMD
(parallel/spmd.py): each rank keeps its rows of the fed batch, and the
parameter gradients are all-reduced in buckets. There are no parameter
servers: `get_pserver_program` and `get_startup_program` raise.
"""

from __future__ import annotations

from typing import Optional

from ..framework.framework import Program, default_main_program
from . import mesh as mesh_mod

__all__ = ["DistributeTranspiler", "memory_optimize", "release_memory"]


class DistributeTranspiler:
    def transpile(self, trainer_id: int = 0, program: Optional[Program] = None,
                  pservers: str = "", trainers: int = 1,
                  split_method=None, mesh=None):
        """Tag `program` for SPMD data parallelism over `trainers` ranks
        (the process group's size), or over an explicit mesh."""
        self.program = program or default_main_program()
        self.trainer_id = trainer_id
        self.trainers = trainers
        if mesh is None:
            mesh = mesh_mod.data_parallel_mesh(
                None if trainers <= 1 else trainers)
        self.mesh = mesh
        self.program._mesh = mesh
        self.program._version = getattr(self.program, "_version", 0) + 1
        return self

    def get_trainer_program(self) -> Program:
        return self.program

    def get_pserver_program(self, endpoint=None):
        raise RuntimeError(
            "There are no parameter servers in the port: the transpiled "
            "program runs synchronous all-reduce data parallelism over the "
            "process group. Run the trainer program on every rank instead.")

    def get_startup_program(self, endpoint=None, pserver_program=None):
        raise RuntimeError(
            "No pserver startup program in the port; run the normal startup "
            "program once on every rank.")


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """The reference's var-reuse rewrite (memory_optimization_transpiler.py
    :332). The port's executor drops each temporary after its last reader
    (executor.liveness), so this returns the program unchanged, as the JAX
    package's does."""
    return input_program


def release_memory(input_program, skip_opt_set=None):
    return input_program
