"""Leopard: the transitive-closure index behind tier 0 of a Check.

The port of the JAX package's ``leopard`` package, as far as Checks need
it: :mod:`ketotpu_torch.leopard.closure` (the host-built index, copied
unchanged) and :mod:`ketotpu_torch.leopard.device` (its pair columns on
the card and the K6 binary search).  The listing APIs
(ListObjects / ListSubjects, the JAX ``leopard/hostlist.py``) are not
ported yet.
"""

from ketotpu_torch.leopard.closure import ClosureIndex

__all__ = ["ClosureIndex"]
