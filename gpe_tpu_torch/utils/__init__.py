"""Host-side utilities: metrics logging and the paper-style error tables."""
