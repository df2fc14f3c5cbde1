"""Animation: linear-blend skinning, and the pose state types the world
holds (the pose engine waits for M4b)."""
