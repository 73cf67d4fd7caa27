"""Trial wavefunctions: the MLP and its ansätze."""
