"""The port's entry points for users, counterparts of the repository's
``examples/`` scripts; run each as a module:

    python -m swift_game_engine_tpu_torch.examples.run_demo   [--device cpu]
    python -m swift_game_engine_tpu_torch.examples.bench_crowd [counts ...]
    python -m swift_game_engine_tpu_torch.examples.play       [--frames N]
"""

import os

# the repository's asset files, beside the package
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "assets")
