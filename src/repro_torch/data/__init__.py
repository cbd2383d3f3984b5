"""The port's data pipeline (``repro.data``)."""
from .pipeline import BinaryTokenDataset, DataConfig, SyntheticLM, make_pipeline

__all__ = ["BinaryTokenDataset", "DataConfig", "SyntheticLM", "make_pipeline"]
