"""Command-line tools of the port (counterpart of `gluefactory_tpu/scripts/`)."""
