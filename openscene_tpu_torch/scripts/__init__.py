"""The port's command-line tools (``python -m
openscene_tpu_torch.scripts.<name>``): the reference-checkpoint drill
(``eval_reference_checkpoint``), the region-order decision
(``decide_region_order``), the synthetic dataset writer
(``make_synthetic_data``), and the benchmarks of the kernels and ops on the
card (``dev_*``, ``timing``)."""
