"""Relation-tuple storage: in-memory and columnar stores, namespace
managers and the traverser the oracle reads through."""
