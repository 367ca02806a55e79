"""Configuration (counterpart of `gluefactory_tpu.core`)."""
