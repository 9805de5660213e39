"""Wall-clock sections with aggregate statistics (counterpart of
``smap_tpu/utils/timer.py``: the reference's header-only ``Timer``,
``extensions/Timer.hpp`` in zju3dv/SMAP, as a context manager).

Host time only: work queued on a card is timed where the section waits
for it (``torch.cuda.synchronize()`` inside the section)."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator


class Timer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        """One line a section, the longest total first."""
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot*1000:.1f} ms, "
                         f"n={n}, avg {tot/n*1000:.2f} ms")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
