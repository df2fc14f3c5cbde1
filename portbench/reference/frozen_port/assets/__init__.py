"""Host-side asset code (numpy + json): mesh descriptors and decimation,
static/skinned mesh and material loaders, procedural meshes, the digits
atlas. The port's own copy of what it uses from swift_game_engine_tpu/assets;
it imports nothing of the JAX package."""
