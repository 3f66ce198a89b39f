"""The reference's dispatch: every call runs eagerly.

Stands where the program's graph cache stands, with the names the frozen
modules call: `graphed(owner, fn, *args)` is `fn(*args)`, and nothing is
captured or replayed, so the reference computes each stage as the program's
eager code did when this copy was taken.
"""

from __future__ import annotations


class Ident:
    """Keys an object by identity (kept for the modules that build keys)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return type(other) is Ident and other.obj is self.obj


def graphed(owner, fn, *args):
    return fn(*args)


def replays(*args) -> bool:
    return False
