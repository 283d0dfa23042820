"""The in-memory data pipeline of the port (``repro/data``)."""

from repro_torch.data.pipeline import DataIterator, InMemoryDataset, Prefetcher  # noqa: F401

__all__ = ["DataIterator", "InMemoryDataset", "Prefetcher"]
