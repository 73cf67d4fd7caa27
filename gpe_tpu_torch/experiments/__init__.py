"""Registered experiment configurations."""
