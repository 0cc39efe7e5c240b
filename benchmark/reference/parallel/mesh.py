"""One rank only: the reference runs the whole batch in one process, so the
port's mesh is never built here. `Mesh` stays a type the copied signatures
name, and a collective is never reached."""

from __future__ import annotations


class Mesh:
    """Never instantiated in the reference."""

    distributed = False
    world = 1
    fsdp = 1


def all_reduce_sum(x, group):
    raise RuntimeError("the reference runs on one rank")
