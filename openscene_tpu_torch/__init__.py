"""openscene_tpu_torch — the PyTorch/CUDA port of ``openscene_tpu``.

Zero-shot open-vocabulary 3D semantic segmentation (OpenScene, CVPR 2023)
on an NVIDIA Hopper GPU: voxelize a scene, build its geometry plans (on the
card, or on the host by the C++ builder of ``csrc/kernel_map.cpp`` or
NumPy), run the distilled MinkUNet forward to CLIP-space features, and
classify each point against text embeddings; also the distillation
trainer and the supervised segmentation baseline.

The package mirrors ``openscene_tpu``'s module layout and names, so every
module has a counterpart there, but it imports nothing of it (nor of JAX):
NumPy-only modules are kept here as copies.  The sparse convolutions that
the JAX package wrote as Pallas TPU kernels are hand-written CUDA kernels
(:mod:`openscene_tpu_torch.csrc`), built with ``nvcc`` at first use
(:mod:`openscene_tpu_torch.sparse._build`).  Each kernel wrapper takes its
plain PyTorch version only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`openscene_tpu_torch.device`).
"""

__version__ = "0.1.0"

# Large freed blocks stay heap-resident, so batch assembly reuses warm pages
# instead of faulting in fresh mappings (utils/hostmem), as the JAX package
# does at import.
from .utils.hostmem import warm_malloc as _warm_malloc

_warm_malloc()
