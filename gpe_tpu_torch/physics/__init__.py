"""Analytic physics: trapping potentials and base eigenfunctions."""
