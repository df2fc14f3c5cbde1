"""Hand-written Hopper kernels (csrc/) behind their wrappers: shadow
sweeps (K2, K3) and closest-hit traversal (K4)."""
