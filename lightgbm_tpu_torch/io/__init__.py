"""Host-side data: the parsers and their ingest guard, the two-round
loader, bin mappers and binned datasets."""
