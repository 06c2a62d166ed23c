"""Epsilon-greedy experiments over retrieval-strategy variants.

A copy of ``advanced_rag_tpu/pipeline/experiments.py`` in the PyTorch port, which never
imports the JAX package.

Capability parity with reference experiments.py:16-113: variant stats,
greedy choice with lexicographic tie-break, auto-registration on
outcome recording.  Uses an injectable RNG instead of the global
`random` module so tests are deterministic.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class VariantStats:
    """Reference experiments.py:16-33."""

    name: str
    config: Dict[str, Any] = field(default_factory=dict)
    trials: int = 0
    successes: int = 0
    total_reward: float = 0.0

    @property
    def success_rate(self) -> float:
        return self.successes / self.trials if self.trials else 0.0

    @property
    def mean_reward(self) -> float:
        return self.total_reward / self.trials if self.trials else 0.0


class ExperimentManager:
    """Reference experiments.py:35-113."""

    def __init__(self, epsilon: float = 0.1,
                 rng: Optional[random.Random] = None):
        self.epsilon = epsilon
        self.variants: Dict[str, VariantStats] = {}
        self._rng = rng or random.Random()

    def register(self, name: str, config: Optional[Dict[str, Any]] = None) -> None:
        if name not in self.variants:
            self.variants[name] = VariantStats(name=name, config=config or {})
        elif config:
            self.variants[name].config.update(config)

    def choose_variant(self) -> Optional[str]:
        """Epsilon-greedy with lexicographic tie-break
        (reference experiments.py:58-85)."""
        if not self.variants:
            return None
        names = sorted(self.variants)
        if self._rng.random() < self.epsilon:
            return self._rng.choice(names)
        return max(names, key=lambda n: (self.variants[n].mean_reward, -names.index(n)))

    def record_outcome(self, name: str, success: bool,
                       reward: Optional[float] = None) -> None:
        """Auto-registers unknown variants (reference experiments.py:87-113)."""
        self.register(name)
        stats = self.variants[name]
        stats.trials += 1
        if success:
            stats.successes += 1
        stats.total_reward += reward if reward is not None else (1.0 if success else 0.0)

    def report(self) -> List[Dict[str, Any]]:
        return [
            {
                "name": v.name,
                "trials": v.trials,
                "success_rate": v.success_rate,
                "mean_reward": v.mean_reward,
                "config": v.config,
            }
            for v in sorted(self.variants.values(), key=lambda v: -v.mean_reward)
        ]


__all__ = ["ExperimentManager", "VariantStats"]
