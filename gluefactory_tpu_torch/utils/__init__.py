"""Host-side helpers: batch trees, metric accumulators, checkpoints, log capture."""
