"""Sampler run report (reference pymc/backends/report.py:24 SamplerReport).

A copy of `pymc_tpu/backends/report.py`, which imports nothing of JAX.
"""

from __future__ import annotations

__all__ = ["SamplerReport"]


class SamplerReport:
    """Warnings + ok status for a sampling run."""

    def __init__(self, warnings=None):
        self._warnings = list(warnings or [])

    @property
    def _log_summary(self):
        return [w.message for w in self._warnings]

    @property
    def ok(self):
        return not any(w.level in ("warn", "error") for w in self._warnings)

    @property
    def warnings(self):
        return list(self._warnings)

    def _add_warnings(self, warnings):
        self._warnings.extend(warnings)

    def __repr__(self):
        status = "ok" if self.ok else "not ok"
        return f"<SamplerReport {status}: {len(self._warnings)} warnings>"
