"""Uncertainty-aware inference (TTA, MC dropout, TTA x MC)."""
