"""Data pipelines of the port (counterpart of ``repro/data``)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
