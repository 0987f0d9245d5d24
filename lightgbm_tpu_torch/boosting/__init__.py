"""Boosting drivers of the port (serial GBDT)."""

from .gbdt import GBDT

__all__ = ["GBDT"]
