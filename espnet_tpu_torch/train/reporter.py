"""Weighted per-epoch statistics (counterpart of
espnet_tpu/train/reporter.py): (epoch, phase)-keyed weighted means, the
epoch log line, best-epoch queries for checkpoint selection, and a
state dict for resume. Plots are not ported."""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, Optional, Tuple


class SubReporter:
    """Weighted sums of one (epoch, phase)."""

    def __init__(self, phase: str, epoch: int):
        self.phase = phase
        self.epoch = epoch
        self._sum: Dict[str, float] = defaultdict(float)
        self._weight: Dict[str, float] = defaultdict(float)
        self._count = 0

    def register(self, stats: Dict[str, float],
                 weight: Optional[float] = None):
        self._count += 1
        w = float(weight) if weight is not None else 1.0
        for k, v in stats.items():
            if v is None:
                continue
            self._sum[k] += float(v) * w
            self._weight[k] += w

    def mean(self, key: str) -> float:
        return self._sum[key] / max(self._weight[key], 1e-20)

    def means(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self._sum}

    def log_message(self) -> str:
        parts = [f"{k}={self.mean(k):.3f}" for k in sorted(self._sum)]
        return (f"{self.epoch}epoch:{self.phase}:{self._count}batches: "
                + ", ".join(parts))


class Reporter:
    """Epoch-keyed store of finished SubReporters."""

    def __init__(self):
        self.stats: Dict[int, Dict[str, Dict[str, float]]] = {}
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def start_epoch(self, phase: str, epoch: Optional[int] = None
                    ) -> SubReporter:
        return SubReporter(phase, self.epoch if epoch is None else epoch)

    def finish_epoch(self, sub: SubReporter):
        self.stats.setdefault(sub.epoch, {})[sub.phase] = sub.means()
        logging.getLogger(__name__).info(sub.log_message())

    def get_value(self, phase: str, key: str, epoch: Optional[int] = None):
        return self.stats[self.epoch if epoch is None else epoch][phase][key]

    def has(self, phase: str, key: str, epoch: Optional[int] = None) -> bool:
        e = self.epoch if epoch is None else epoch
        return key in self.stats.get(e, {}).get(phase, {})

    def _items(self, phase: str, key: str):
        return [(e, p[phase][key]) for e, p in self.stats.items()
                if phase in p and key in p[phase]]

    def best_epoch(self, phase: str, key: str, mode: str = "min"
                   ) -> Tuple[int, float]:
        assert mode in ("min", "max")
        items = self._items(phase, key)
        if not items:
            return -1, float("inf") if mode == "min" else float("-inf")
        return (min if mode == "min" else max)(items, key=lambda x: x[1])

    def sort_epochs(self, phase: str, key: str, mode: str = "min"):
        return [e for e, _ in sorted(self._items(phase, key),
                                     key=lambda x: x[1],
                                     reverse=(mode == "max"))]

    def state_dict(self) -> dict:
        return {"stats": {str(e): v for e, v in self.stats.items()},
                "epoch": self.epoch}

    def load_state_dict(self, d: dict):
        self.stats = {int(e): v for e, v in d["stats"].items()}
        self.epoch = d["epoch"]
