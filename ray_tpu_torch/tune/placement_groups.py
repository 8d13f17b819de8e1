"""Trial resource reservation (port of
``ray_tpu/tune/placement_groups.py``; reference:
``python/ray/tune/execution/placement_groups.py`` PlacementGroupFactory).

A trial that is itself a multi-worker trainer gang must reserve ALL its
resources atomically — if each trial's inner worker group raced for
capacity piecemeal, two half-placed gangs could deadlock the cluster.
The factory declares the trial's full bundle list up front; the Tuner
creates one placement group per trial from it, runs the trial driver in
bundle 0, and hands the group to the inner trainer so its workers land
in bundles 1..N (the reference's convention: first bundle is the
trainable actor, the rest are its workers — base_trainer.py:538 →
tune/execution/placement_groups.py).
"""

from __future__ import annotations

from typing import Dict, List


class PlacementGroupFactory:
    def __init__(self, bundles: List[Dict[str, float]],
                 strategy: str = "PACK"):
        if not bundles:
            raise ValueError("PlacementGroupFactory requires >= 1 bundle")
        self.bundles = [dict(b) for b in bundles]
        self.strategy = strategy

    @property
    def head_bundle(self) -> Dict[str, float]:
        return dict(self.bundles[0])

    def __repr__(self):
        return (f"PlacementGroupFactory({self.bundles}, "
                f"strategy={self.strategy!r})")
