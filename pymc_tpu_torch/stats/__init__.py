"""Convergence diagnostics (numpy and scipy only)."""
