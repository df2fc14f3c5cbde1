"""The one traffic generator: a mix is a JSON file of parameters.

``loop: "frames"`` — a closed loop of ``Engine.frame(dt, pad)`` calls
along a fixed route. ``route`` is a list of legs ``[seconds, lx, ly, rx,
ry]``: the pad's sticks held for that many seconds of game time (frame
``k`` starts at ``k * dt``), the legs repeated in order. The route does not
depend on the seed, so every seed gives the program the same work.

``loop: "substeps"`` — ``SubstepGraph.step()`` replays back to back, at
most ``in_flight`` unfinished on the card.

The seed draws only the answers the check compares: ``sample_indices``
picks them among the first ``check_window`` frames or replays of the
window.
"""

from __future__ import annotations

import numpy as np


def rng_of(seed: int, *salt: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream ``salt``."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *salt])


class FrameTraffic:
    """The pad inputs of a frame loop, frame after frame."""

    def __init__(self, mix: dict):
        self.dt = float(mix["dt"])
        self.route = [tuple(float(x) for x in leg) for leg in mix["route"]]
        self.period = sum(leg[0] for leg in self.route)
        self.k = 0

    def sticks_at(self, k: int):
        """(lx, ly, rx, ry) of frame ``k``."""
        t = (k * self.dt) % self.period
        for seconds, *sticks in self.route:
            if t < seconds:
                return tuple(sticks)
            t -= seconds
        return tuple(self.route[-1][1:])

    def next(self):
        """(dt, (lx, ly, rx, ry)) of the next frame."""
        sticks = self.sticks_at(self.k)
        self.k += 1
        return self.dt, sticks


def sample_indices(mix: dict, seed: int, count: int):
    """``count`` distinct indices among the first ``check_window`` answers
    of the window, drawn from the seed."""
    window = int(mix["check_window"])
    count = min(count, window)
    return sorted(int(i) for i in rng_of(seed, 2).choice(
        window, size=count, replace=False))
