"""Host-side data: the parsers and their ingest guard, the two-round
loader, bin mappers and binned datasets."""

from .binning import CATEGORICAL, NUMERICAL, BinMapper
from .dataset import BinnedDataset, Metadata
from .guard import IngestGuard, read_quarantine
from .parser import detect_format, parse_file

__all__ = ["BinMapper", "BinnedDataset", "CATEGORICAL", "IngestGuard",
           "Metadata", "NUMERICAL", "detect_format", "parse_file",
           "read_quarantine"]
