"""Numerical operators: forward-Laplacian MLP, Hamiltonian, quadrature."""
