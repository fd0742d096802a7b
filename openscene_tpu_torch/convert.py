"""Carry the JAX package's (params, state) trees across to the port.

``openscene_tpu`` keeps MinkUNet (and ResNet) weights as nested dicts/lists of arrays
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
:func:`optimizer_state_from_optax` carries the optimizer's state of a JAX
checkpoint onto the port's torch optimizer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .models.resnet import RESNET_ARCHS
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


def resnet_params_from_jax(params, state, arch: str
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``init_resnet`` (params, state) trees -> the port's ``ResNet``
    state_dict."""
    a = RESNET_ARCHS[arch]
    for b in range(1, 5):
        if len(params[f"block{b}"]) != a.layers[b - 1]:
            raise ValueError(f"block{b} has {len(params[f'block{b}'])} "
                             f"blocks, {arch} has {a.layers[b - 1]}")
    flat = {**flatten_tree(params), **flatten_tree(state)}
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def _field(tree: Any, key: str) -> Optional[dict]:
    """The first map (depth first) of ``tree`` that holds ``key``."""
    if isinstance(tree, dict):
        if key in tree:
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        hit = _field(child, key)
        if hit is not None:
            return hit
    return None


def optimizer_state_from_optax(optimizer: torch.optim.Optimizer,
                               model: torch.nn.Module, opt_state) -> int:
    """Load a JAX optimizer state (the ``opt_state`` tree of a checkpoint)
    into ``optimizer`` over ``model``'s parameters; returns the number of
    updates it has taken (the schedule's count).

    * ``optax.adam`` (the distill trainer): ``ScaleByAdamState``'s ``mu``,
      ``nu`` and ``count`` become torch Adam's ``exp_avg``, ``exp_avg_sq``
      and ``step``; the two take the same update from them.
    * ``add_decayed_weights`` + ``sgd(momentum)`` (the seg trainer):
      ``TraceState.trace`` becomes torch SGD's ``momentum_buffer``, and the
      count is the schedule state's."""
    params = dict(model.named_parameters())

    def per_param(tree) -> Dict[str, torch.Tensor]:
        flat = flatten_tree(tree)
        if set(flat) != set(params):
            raise ValueError(f"optimizer state names {sorted(flat)[:3]}... do "
                             f"not match the model's parameters")
        return {n: torch.from_numpy(np.array(v, dtype=np.float32)).to(
            params[n]) for n, v in flat.items()}

    if isinstance(optimizer, torch.optim.Adam):
        adam = _field(opt_state, "mu")
        if adam is None or "nu" not in adam:
            raise ValueError("no ScaleByAdamState (mu, nu) in opt_state")
        count = int(np.asarray(adam["count"]))
        mu, nu = per_param(adam["mu"]), per_param(adam["nu"])
        for n, p in params.items():
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        return count
    if isinstance(optimizer, torch.optim.SGD):
        trace, sched = _field(opt_state, "trace"), _field(opt_state, "count")
        if trace is None or sched is None:
            raise ValueError("no TraceState / schedule count in opt_state")
        buf = per_param(trace["trace"])
        for n, p in params.items():
            optimizer.state[p] = {"momentum_buffer": buf[n]}
        return int(np.asarray(sched["count"]))
    raise NotImplementedError(f"optax state for {type(optimizer).__name__}")
