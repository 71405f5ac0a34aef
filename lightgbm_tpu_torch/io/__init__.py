"""Host-side data representation: bin mappers and binned datasets."""
