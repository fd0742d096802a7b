"""Convert reference PyTorch/MinkowskiEngine checkpoints for the port.

Counterpart of ``openscene_tpu/utils/convert_checkpoint.py``.  The published
OpenScene checkpoints (``*.pth.tar``) are torch pickles of
``{'state_dict': ...}`` with MinkowskiEngine module names
(``conv0p1s1.kernel``, ``bn0.bn.weight``, ``block1.0.downsample.0.kernel``,
...; an optional DataParallel ``module.`` / ``net3d.`` prefix).
``convert_state_dict`` maps them onto the JAX package's (params, state)
tree layout, as NumPy arrays, which
:func:`openscene_tpu_torch.convert.params_from_jax` turns into the port's
``state_dict``:

* conv kernels keep their (K, C_in, C_out) layout but the kernel-offset axis
  is permuted from ME's region order to this engine's x-major
  ``stencil_offsets`` order (last coordinate fastest);
* MinkowskiBatchNorm ``bn.weight/bias/running_mean/running_var`` become
  (gamma, beta) params + (mean, var) state.

ME's region order (which spatial axis varies fastest along the K axis) is
the switchable ``region_order`` parameter: ``"x_fastest"`` (default) or
``"z_fastest"`` (C order, identical to ``stencil_offsets``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.sparse_unet import ARCHS
from ..sparse.types import stencil_offsets

REGION_ORDERS = ("x_fastest", "z_fastest")


def me_offset_permutation(kernel_size: int,
                          region_order: str = "x_fastest") -> np.ndarray:
    """perm[j] = index in ME's region order of our j-th offset.

    Ours (itertools.product) increments the last (z) coordinate fastest;
    ME's assumed order is set by ``region_order`` (module docstring).
    """
    assert region_order in REGION_ORDERS, region_order
    ours = stencil_offsets(kernel_size)
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        axis = list(range(-r, r + 1))
    else:
        axis = list(range(kernel_size))
    me_order = {}
    idx = 0
    for a in axis:
        for b in axis:
            for c in axis:
                if region_order == "x_fastest":
                    me_order[(c, b, a)] = idx  # x fastest, z slowest
                else:
                    me_order[(a, b, c)] = idx  # z fastest (C order)
                idx += 1
    return np.array([me_order[tuple(o)] for o in ours.tolist()],
                    dtype=np.int64)


def _kernel(sd: Dict[str, np.ndarray], name: str, kernel_size: int,
            region_order: str = "x_fastest") -> np.ndarray:
    w = np.asarray(sd[name + ".kernel"], dtype=np.float32)
    if w.ndim == 2:  # 1x1 convs are stored (C_in, C_out)
        return w[None]
    perm = me_offset_permutation(kernel_size, region_order)
    return w[perm]


def _bn(sd: Dict[str, np.ndarray], name: str):
    p = {"gamma": np.asarray(sd[name + ".bn.weight"], np.float32),
         "beta": np.asarray(sd[name + ".bn.bias"], np.float32)}
    s = {"mean": np.asarray(sd[name + ".bn.running_mean"], np.float32),
         "var": np.asarray(sd[name + ".bn.running_var"], np.float32)}
    return p, s


def convert_state_dict(sd: Dict[str, np.ndarray], arch: str = "MinkUNet18A",
                       region_order: str = "x_fastest"):
    """torch state_dict (numpy-valued) -> (params, state) trees."""
    # strip DataParallel / wrapper prefixes
    def strip(k):
        for pre in ("module.", "net3d."):
            if k.startswith(pre):
                k = k[len(pre):]
        return k

    sd = {strip(k): v for k, v in sd.items()}
    a = ARCHS[arch]
    P: Dict = {}
    S: Dict = {}
    P["conv0"] = _kernel(sd, "conv0p1s1", 5, region_order)
    P["bn0"], S["bn0"] = _bn(sd, "bn0")
    for i in range(1, 5):
        P[f"conv{i}"] = _kernel(sd, f"conv{i}p{2 ** (i - 1)}s2", 2,
                                region_order)
        P[f"bn{i}"], S[f"bn{i}"] = _bn(sd, f"bn{i}")
    for i in range(4, 8):
        P[f"convtr{i}"] = _kernel(sd, f"convtr{i}p{2 ** (8 - i)}s2", 2,
                                  region_order)
        P[f"bntr{i}"], S[f"bntr{i}"] = _bn(sd, f"bntr{i}")
    for b in range(1, 9):
        blocks = []
        states = []
        for j in range(a.layers[b - 1]):
            prefix = f"block{b}.{j}"
            bp: Dict = {}
            bs: Dict = {}
            bp["conv1"] = _kernel(sd, prefix + ".conv1", 3, region_order)
            bp["bn1"], bs["bn1"] = _bn(sd, prefix + ".norm1")
            bp["conv2"] = _kernel(sd, prefix + ".conv2", 3, region_order)
            bp["bn2"], bs["bn2"] = _bn(sd, prefix + ".norm2")
            if a.block == "bottleneck":
                bp["conv3"] = _kernel(sd, prefix + ".conv3", 3, region_order)
                bp["bn3"], bs["bn3"] = _bn(sd, prefix + ".norm3")
            if prefix + ".downsample.0.kernel" in sd:
                bp["down"] = _kernel(sd, prefix + ".downsample.0", 1,
                                     region_order)
                bp["down_bn"], bs["down_bn"] = _bn(sd,
                                                   prefix + ".downsample.1")
            blocks.append(bp)
            states.append(bs)
        P[f"block{b}"] = blocks
        S[f"block{b}"] = states
    P["final"] = _kernel(sd, "final", 1, region_order)
    return P, S


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    import torch
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}
