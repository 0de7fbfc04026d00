"""Public API types and typed errors (copied from ``ketotpu.api``)."""
