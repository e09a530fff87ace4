"""Per-stage timing instrumentation.

Copy of ``orb_slam3_fast_tpu/utils/timers.py`` (numpy and stdlib only; the
JAX package's import would pull in jax).  ORB-SLAM3's ``REGISTER_TIMES``
machinery (``include/System.h:43``, ``Tracking.h:44``): steady-clock
spans around each pipeline stage collected into per-stage vectors
(Tracking.h:185-194) and dumped as mean±std plus per-frame CSVs on shutdown
(``Tracking::PrintTimeStats``/``TrackStats2File``, Tracking.cc:189-268).
Same CSV schema so the reference README's latency tables are reproducible.
"""
from __future__ import annotations

import time
from contextlib import contextmanager


class StageTimers:
    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float):
        """InsertRectTime/InsertResizeTime/InsertTrackTime analogue
        (System.cc:1417-1428)."""
        self.spans.setdefault(name, []).append(ms)

    def summary(self) -> str:
        """Mean±std per stage (ExecMean.txt schema)."""
        import numpy as np

        lines = []
        for name, v in sorted(self.spans.items()):
            a = np.asarray(v)
            lines.append(f"{name}: {a.mean():.3f} ms (+/- {a.std():.3f}), n={len(a)}")
        return "\n".join(lines)

    def to_csv(self, path: str):
        """Per-frame stage times (TrackStats2File schema, Tracking.cc:220)."""
        import numpy as np

        names = sorted(self.spans)
        n = max((len(v) for v in self.spans.values()), default=0)
        with open(path, "w") as f:
            f.write(",".join(names) + "\n")
            for i in range(n):
                f.write(
                    ",".join(
                        f"{self.spans[k][i]:.4f}" if i < len(self.spans[k]) else ""
                        for k in names
                    )
                    + "\n"
                )
