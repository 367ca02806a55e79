"""Profiling tools of the port: counterparts of the JAX package's
`scripts_dev/` prototypes, run as `python -m gluefactory_tpu_torch.scripts_dev.<name>`."""
