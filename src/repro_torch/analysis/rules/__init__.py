"""Lint rule registry. A rule is a module with ``NAME``, ``DESCRIPTION``
and ``check(module) -> iterable[Finding]``; add new rules here."""
from __future__ import annotations

from . import divergence, errors, f64, host_sync, scatter, static_fields

ALL = (host_sync, static_fields, divergence, errors, f64, scatter)

__all__ = ["ALL", "host_sync", "static_fields", "divergence", "errors",
           "f64", "scatter"]
