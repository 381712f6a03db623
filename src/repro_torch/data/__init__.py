"""Synthetic corpora (port of ``repro.data``)."""

from .synthetic import DevicePlantedChunks, PlantedCCAData

__all__ = ["DevicePlantedChunks", "PlantedCCAData"]
