"""Synthetic LM data (counterpart of ``src/repro/data``)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
