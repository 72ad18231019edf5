"""Fault handling: step timing and straggler detection.

The port of the JAX package's ``dist/fault.py``. Every train step of
``launch/train.py`` is timed with :class:`StepTimer`;
:class:`StragglerMonitor` flags steps slower than ``factor`` x the
rolling median of recent *healthy* steps. Flagged steps are kept out of
the baseline, so a persistent slowdown keeps alerting.
"""
from __future__ import annotations

import statistics
import time
from collections import deque


class StepTimer:
    """``with StepTimer() as t: ...`` then read ``t.seconds``. On the card
    the timed block ends in a device synchronise
    (:mod:`repro_torch.launch.train`), as the JAX launcher's ends in
    ``block_until_ready``."""

    def __enter__(self) -> "StepTimer":
        self.seconds = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        return False


class StragglerMonitor:
    """Rolling-median straggler detector.

    record(seconds) -> True when the step is a straggler: slower than
    ``factor`` x the median of the last ``window`` healthy steps. The
    first ``min_history`` steps are warmup (compilation, cache fill) and
    never flagged.
    """

    def __init__(self, factor: float = 2.0, window: int = 16,
                 min_history: int = 3):
        assert factor > 1.0 and window >= min_history >= 1
        self.factor = factor
        self.window = window
        self.min_history = min_history
        self.slow_steps = 0
        self._healthy = deque(maxlen=window)

    @property
    def baseline(self) -> float:
        return statistics.median(self._healthy) if self._healthy else 0.0

    def record(self, seconds: float) -> bool:
        slow = (len(self._healthy) >= self.min_history
                and seconds > self.factor * self.baseline)
        if slow:
            self.slow_steps += 1
        else:
            self._healthy.append(seconds)
        return slow
