"""Data substrate (port of ``repro.data``): feature hashing and
synthetic paired-view corpora and token streams."""

from .hashing import HashingFeaturizer
from .synthetic import DevicePlantedChunks, PlantedCCAData, SyntheticTokenStream, planted_views

__all__ = [
    "DevicePlantedChunks",
    "HashingFeaturizer",
    "PlantedCCAData",
    "SyntheticTokenStream",
    "planted_views",
]
