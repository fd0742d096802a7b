"""Mean ms of ``FusedFeatureLoader.get`` (load the scene and its fused
features, scatter them to the full cloud, voxelize), in the evaluator's
prefetch threads: a span from the benchmark's side."""


def read(r):
    return r.span_ms("loader")
