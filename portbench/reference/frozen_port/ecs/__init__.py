"""ECS: the world state as NamedTuples of tensors, and its builder."""
