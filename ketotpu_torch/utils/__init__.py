"""Synthetic permission graphs for tests and the chip smoke run."""
