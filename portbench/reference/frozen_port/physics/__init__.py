"""Physics: collision queries, the character mover, agent separation and
the per-substep systems, as PyTorch tensor code batched over agents."""
