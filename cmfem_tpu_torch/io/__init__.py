from .vtu import VTUCollection
from .csvio import CsvWriter

__all__ = ["VTUCollection", "CsvWriter"]
