"""GPE loss terms and weighting."""
