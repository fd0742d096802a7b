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
:func:`probe_region_order` picks it empirically from a trained checkpoint
and one scene, and :func:`main` converts a checkpoint on the command line:

    python -m openscene_tpu_torch.utils.convert_checkpoint \
        scannet_openseg.pth.tar out/model_converted.pth \
        --arch MinkUNet18A [--probe_scene scene.npz,scene_fused.npz]

It writes ``{"epoch": 0, "model": <the port's MinkUNet state_dict>,
"best_iou": 0.0}`` with ``torch.save``, which
``runtime.evaluate.load_weights`` reads as ``model_path``.
"""

from __future__ import annotations

import argparse
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


def _port_state_dict(sd: Dict[str, np.ndarray], arch: str, region_order: str):
    """The converted checkpoint as the port's ``MinkUNet`` state_dict
    (the head's width from the checkpoint's ``final`` kernel)."""
    from ..convert import params_from_jax
    params, state = convert_state_dict(sd, arch, region_order=region_order)
    return params_from_jax(params, state, arch), params["final"].shape[-1]


def probe_region_order(sd: Dict[str, np.ndarray], arch: str,
                       scene_coords: np.ndarray, scene_feat_3d: np.ndarray,
                       feat_mask: np.ndarray, voxel_size: float = 0.02,
                       device=None):
    """Empirically pick ME's region order from a trained checkpoint (the
    JAX package's ``probe_region_order``).

    Converts the checkpoint under BOTH candidate orders and measures the
    distill objective (mean cosine similarity between model output and the
    scene's fused 2D features) on one real scene, in bf16 with the constant
    input on ``device`` (``cuda`` by default), the cosines' products there
    too.  A trained model only aligns
    with its targets under the correct order: the wrong order spatially
    scrambles every 27-tap kernel.  Returns ``(best_order, {order:
    mean_cos})``."""
    import torch

    from ..data.batch import assemble_distill_batch
    from ..data.loaders import SceneSample
    from ..device import resolve_device
    from ..models.sparse_unet import MinkUNet
    from ..sparse.geometry import geometry_to_device

    dev = resolve_device(device)
    coords = np.floor(scene_coords / voxel_size).astype(np.int32)
    coords -= coords.min(0)
    _, first = np.unique(
        coords[:, 0].astype(np.int64) * 2 ** 42
        + coords[:, 1].astype(np.int64) * 2 ** 21 + coords[:, 2],
        return_index=True)
    vox_mask = feat_mask[first]
    sample = SceneSample(
        coords=coords[first],
        feats=np.ones((len(first), 3), np.float32),
        labels=np.zeros(len(first), np.int64), inds_reconstruct=None,
        feat_3d=scene_feat_3d[first][vox_mask],
        feat_mask=vox_mask)
    batch = assemble_distill_batch([sample], scene_feat_3d.shape[1],
                                   rng=np.random.default_rng(0), shift=False)
    geo = geometry_to_device(batch.geo, dev)
    x = torch.as_tensor(batch.feats, device=dev).to(torch.bfloat16)

    m = batch.mask > 0
    # the targets' norms in fp16 on the host, as the JAX package takes them;
    # the products with the (rows, C) outputs on the device
    t_norm = np.linalg.norm(batch.feat_3d[m], axis=-1)
    rows = torch.as_tensor(np.flatnonzero(m), device=dev)
    t = torch.as_tensor(batch.feat_3d[m], device=dev).float()
    scores = {}
    for order in REGION_ORDERS:
        state_dict, dim = _port_state_dict(sd, arch, order)
        model = MinkUNet(3, dim, arch)
        model.load_state_dict(state_dict)
        model.to(dev).eval()
        with torch.no_grad():
            out = model(x, geo, constant_input=True).float()[rows]
            num = (out * t).sum(-1).cpu().numpy()
            out_norm = torch.linalg.vector_norm(out, dim=-1).cpu().numpy()
        scores[order] = float((num / (out_norm * t_norm + 1e-8)).mean())
    best = max(scores, key=scores.get)
    return best, scores


def load_probe_scene(scene_path: str, fused_path: str):
    """``(coords, feat_3d, mask)`` of a probe scene: the scene file's point
    coordinates, and its fused-feature blob (``{"feat", "mask_full"}``)
    scattered to one fp32 row per point, zero where ``mask_full`` is off;
    the inputs of :func:`probe_region_order`."""
    from ..data.scene_io import load_fused_features, load_scene
    coords, _, _ = load_scene(scene_path)
    blob = load_fused_features(fused_path)
    feat, mask_full = blob["feat"], blob["mask_full"].astype(bool)
    full = np.zeros((len(coords), feat.shape[1]), np.float32)
    full[mask_full] = feat.astype(np.float32)
    return coords, full, mask_full


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    import torch
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a reference (MinkowskiEngine) checkpoint to the "
                    "port's MinkUNet state_dict")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--arch", default="MinkUNet18A")
    ap.add_argument("--out_channels", type=int, default=768)
    ap.add_argument("--region_order", default="x_fastest",
                    choices=REGION_ORDERS)
    ap.add_argument("--probe_scene", default="",
                    help="scene .npz + its fused-feature .npz "
                         "(comma-separated) to pick region_order empirically")
    ap.add_argument("--device", default=None,
                    help="the probe's device (default cuda)")
    args = ap.parse_args(argv)
    import torch

    from ..models.sparse_unet import MinkUNet
    sd = load_torch_checkpoint(args.src)
    region_order = args.region_order
    if args.probe_scene:
        coords, full, mask_full = load_probe_scene(
            *args.probe_scene.split(","))
        region_order, scores = probe_region_order(
            sd, args.arch, coords, full, mask_full, device=args.device)
        print(f"probe scores {scores} -> region_order={region_order}")
    state_dict, dim = _port_state_dict(sd, args.arch, region_order)
    if dim != args.out_channels:
        raise ValueError(f"the checkpoint's head is {dim}-d, "
                         f"--out_channels {args.out_channels}")
    # validate against a freshly built model of the same arch
    MinkUNet(3, args.out_channels, args.arch).load_state_dict(state_dict)
    torch.save({"epoch": 0, "model": state_dict, "best_iou": 0.0}, args.dst)
    print("wrote", args.dst)


if __name__ == "__main__":
    main()
