from .vtu import VTUCollection
from .csvio import CsvWriter
from .output import file_output, writes_files

__all__ = ["VTUCollection", "CsvWriter", "file_output", "writes_files"]
