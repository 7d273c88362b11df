"""PolyInts: a coefficient list that carries its canonical bytes.

The native host engine (``native/``) works on (n, 32) arrays of canonical
little-endian field elements. A polynomial made on that engine keeps its
array beside its ints, so the engine's consumers (the quotient's batch,
Horner evaluations, the multiopen folds, commitments) skip the
int -> bytes marshalling. Only the native engine's routes make one.
"""

from __future__ import annotations


class PolyInts(list):
    """A coefficient list that also carries its (n, 32) canonical-bytes
    array (``bytes_arr``). Semantically a plain list. Any in-place mutation
    drops ``bytes_arr`` (getattr then gives None and the consumer marshals
    the ints again), so no consumer reads stale bytes; a slice is a plain
    list."""

    __slots__ = ("bytes_arr",)

    @staticmethod
    def wrap(ints, bytes_arr) -> "PolyInts":
        p = PolyInts(ints)
        p.bytes_arr = bytes_arr
        return p

    def _drop(self):
        try:
            del self.bytes_arr
        except AttributeError:
            pass


def _dropping(name: str):
    method = getattr(list, name)

    def mutate(self, *args, **kw):
        self._drop()
        return method(self, *args, **kw)

    mutate.__name__ = name
    return mutate


for _name in ("__setitem__", "__delitem__", "__iadd__", "__imul__", "append", "extend", "insert", "pop",
              "remove", "sort", "reverse", "clear"):
    setattr(PolyInts, _name, _dropping(_name))
