"""HTTP check surface over a port engine."""
