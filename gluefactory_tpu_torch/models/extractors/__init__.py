"""Local-feature extractors."""
