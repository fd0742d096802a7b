"""Carry the JAX package's (params, state) trees across to the port.

``openscene_tpu`` keeps MinkUNet weights as nested dicts/lists of arrays
(``models/sparse_unet.py:init_unet``); the port's ``MinkUNet`` names its
parameters and buffers by the same paths, so the conversion is a flatten:
``params["block1"][0]["conv1"]`` becomes ``"block1.0.conv1"``, and the BN
statistics of ``state`` join their layer as ``".mean"`` / ``".var"``.
Layouts are unchanged: conv weights stay (K, C_in, C_out) fp32 in the same
offset order.

The trees arrive as NumPy arrays (``np.asarray`` of each leaf); nothing
here imports JAX.  :func:`flatten_tree` gives the same dotted names for any
tree of that shape (gradients, updated parameters), so a test can hold the
port's ``.grad``s against a JAX gradient tree by name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.sparse_unet import ARCHS


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def flatten_tree(tree) -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {dotted name: ndarray}, e.g.
    ``tree["block1"][0]["bn1"]["gamma"]`` -> ``"block1.0.bn1.gamma"``."""
    out: Dict[str, np.ndarray] = {}
    _flatten(tree, "", out)
    return out


def params_from_jax(params, state, arch: str) -> Dict[str, torch.Tensor]:
    """JAX (params, state) trees -> the port's ``MinkUNet`` state_dict."""
    a = ARCHS[arch]
    for b in range(1, 9):
        if len(params[f"block{b}"]) != a.layers[b - 1]:
            raise ValueError(f"block{b} has {len(params[f'block{b}'])} "
                             f"blocks, {arch} has {a.layers[b - 1]}")
    flat = {**flatten_tree(params), **flatten_tree(state)}
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}
