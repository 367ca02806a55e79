"""Backbones of detector-free matchers."""
