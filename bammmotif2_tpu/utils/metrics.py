"""Structured run metrics: JSONL event stream.

Extension beyond the reference's stdout prints (``main.cpp`` runtime
printouts, ``--verbose`` per-iteration log-likelihoods — SURVEY.md §5
Metrics/logging row): every pipeline stage emits one JSON object per line
to ``<outdir>/<basename>.metrics.jsonl`` when ``--jsonl`` is set, carrying
the numbers a production deployment monitors (per-motif EM iterations,
final log-likelihood, q, windows/sec, scan hit counts, FDR summaries,
wall-clock per stage).
"""

from __future__ import annotations

import json
import time


class MetricsLogger:
    """Append-only JSONL event writer; a no-op when disabled."""

    def __init__(self, path: str | None):
        self.path = path
        self._fh = open(path, "w") if path else None
        self.t0 = time.perf_counter()

    def event(self, kind: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"event": kind, "t": round(time.perf_counter() - self.t0, 4)}
        rec.update(fields)
        self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(x):
    try:
        import numpy as np

        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, np.ndarray):
            return x.tolist()
    except ImportError:
        pass
    return str(x)
