"""Benchmarks of the port's kernels and ops on the card (run as
``python -m openscene_tpu_torch.scripts.<name>``)."""
