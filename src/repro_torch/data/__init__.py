"""Synthetic data pipeline of the port (a copy of ``repro/data``)."""
from repro_torch.data.pipeline import DataPipeline, batch_to_device

__all__ = ["DataPipeline", "batch_to_device"]
