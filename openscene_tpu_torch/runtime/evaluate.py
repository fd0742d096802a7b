"""Zero-shot open-vocabulary evaluation (fusion / distill / ensemble).

Counterpart of ``openscene_tpu/runtime/evaluate.py`` (reference protocol
``run/evaluate.py:224-425``), on one CUDA device by default:

* per-point features (fused 2D, distilled 3D, or a confidence ensemble) are
  matched to CLIP text embeddings by dot product; argmax = predicted class;
* the ensemble keeps, per point, whichever feature's best normalized text
  logit is higher, then classifies with the *unnormalized* chosen feature
  (run/evaluate.py:302-324);
* ``mark_no_feature_to_unknown``: points with no fused feature predict the
  NO_FEATURE sentinel 256 in the final metric (fusion mode only);
* ``test_repeats``: the whole pass re-runs with reseeded voxelization and
  **summed logits** across repeats before the final argmax
  (run/evaluate.py:263-278,414-425).

Voxelization and batch assembly run on the host; the UNet forward, the
ensemble and the text product run on the device, each scene's geometry
reaching it through ``runtime/geometry_route.py`` (:class:`SceneGeometry`;
fusion builds none).  The fused features go to the device only in the
modes that read them (fusion, ensemble); for a scene whose geometry was
built on the card the host ships the scene's own ``(n, D)`` rows and sort
order, and the device places them at the sorted, padded voxel rows
(:class:`FusedPlacement`).

Multi-GPU (``data_parallel``, one process per GPU, ``parallel/mesh.py``):
rank ``r`` of ``W`` runs scenes ``r, r + W, ...`` of every repeat, in rounds
of ``W`` scenes, and writes its scenes' feature files; rank 0 gathers, round
by round, what the metric reads of every scene (point logits, feature mask,
labels; never the (N, 768) features) and runs the protocol unchanged, and
every rank returns its results, each scene's on the caps and so with the
logits of a one-GPU run (:func:`rank_scene_rounds`; the kernels' tiles
follow the caps).  Launch with torchrun, the config's ``coordinator_address``/
``num_processes``/``process_id``, or ``main`` alone, which starts
``data_parallel`` local processes.

With ``vis_input``/``vis_pred``/``vis_gt`` every rank writes its scenes'
PLY clouds and legends into ``save_folder`` (:meth:`ZeroShotEvaluator.
_visualize`).  ``model_path`` may be an http(s) URL, fetched once into a
cache (:func:`fetch_checkpoint`).

Run: ``python -m openscene_tpu_torch.runtime.evaluate --config <yaml>
[--device cuda|cpu] [key value]*``
"""

from __future__ import annotations

import os
import sys
import time
from os.path import join
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import metrics
from ..config import Config, dataset_name_from_root, load_cli
from ..data.batch import (RawEvalBatch, assemble_eval_batch,
                          assemble_raw_eval_sorted)
from ..data.loaders import FusedFeatureLoader
from ..device import resolve_device
from ..labels import NO_FEATURE_ID, labelset_and_palette
from ..models.disnet import build_disnet, output_dim
from ..models.sparse_unet import MinkUNet
from ..parallel import launch
from ..parallel.mesh import broadcast_from_main, gather_to_main, mesh_for
from ..sparse.geometry import geometry_to_device
from ..sparse.types import UNetGeometry
from ..text import extract_text_features
from ..utils.profiling import span
from ..utils.train_utils import get_logger, read_checkpoint
from .geometry_route import SceneGeometry, rank_scene_rounds

log = get_logger()

ENSEMBLE_EPS = 1e-5  # run/evaluate.py's normalisation guard


def _normalize(f: torch.Tensor) -> torch.Tensor:
    """``f / (||f|| + eps)`` in f's dtype; the sum of squares accumulates in
    fp32 (as jnp.linalg.norm does for fp16 input)."""
    norm = torch.sqrt((f * f).sum(-1, keepdim=True, dtype=torch.float32)
                      .to(f.dtype))
    return f / (norm + ENSEMBLE_EPS)


def make_eval_step(mode: str, compute_dtype=torch.bfloat16,
                   constant_input: bool = True,
                   return_features: bool = False):
    """Build the per-batch step ``step(model, text, batch, geo=None)``.

    ``text`` is the (num_classes, D) fp32 embedding tensor on the device the
    step runs on; ``batch`` an :class:`EvalBatch` of host arrays, or a
    :class:`RawEvalBatch` with ``geo`` its geometry already on the device.
    Only fusion and ensemble read (and copy) ``batch.feat_3d``.  Returns
    device tensors (point_logits, point_feat_mask[, point_features]); the
    optional third output is the per-point feature matrix the reference
    saves with ``save_feature_as_numpy`` (model output for distill, fused
    feature for fusion, the blended ``feat_ensemble`` for ensemble)."""

    @torch.no_grad()
    def step(model: Optional[MinkUNet], text: torch.Tensor, batch,
             geo: Optional[UNetGeometry] = None):
        device = text.device
        text_t = text.t().float()

        def model_features():
            g = geo if geo is not None else geometry_to_device(batch.geo,
                                                               device)
            x = torch.as_tensor(batch.feats, device=device).to(compute_dtype)
            return model(x, g, constant_input=constant_input)  # fp32

        def fused_features():
            return torch.as_tensor(batch.feat_3d, device=device)  # fp16

        if mode == "distill":
            feat_v = model_features()
            pred_v = feat_v @ text_t
        elif mode == "fusion":
            feat_v = fused_features().float()
            pred_v = feat_v @ text_t
        elif mode == "ensemble":
            out = model_features()
            fused = fused_features()
            logit_d = _normalize(out) @ text_t
            logit_f = _normalize(fused).float() @ text_t
            use_fusion = logit_d.amax(-1) < logit_f.amax(-1)
            feat_v = torch.where(use_fusion[:, None], fused.float(), out)
            pred_v = feat_v @ text_t
        else:
            raise NotImplementedError(mode)

        inds = torch.as_tensor(batch.inds_reconstruct, device=device).long()
        point_logits = pred_v.index_select(0, inds)
        point_mask = torch.as_tensor(batch.mask, device=device
                                     ).index_select(0, inds)
        if return_features:
            return point_logits, point_mask, feat_v.index_select(0, inds)
        return point_logits, point_mask

    return step


class FusedPlacement:
    """A scene's fused features at its sorted, padded voxel rows on the
    device: the ``(cap0, D)`` fp16 tensor whose rows ``[:n]`` are the
    scene's ``(n, D)`` rows gathered by the sort order ``perm``
    (:func:`assemble_raw_eval_sorted`) and whose other rows are zero, the
    host's ``(cap0, D)`` buffer bit for bit.  On CUDA the rows and ``perm``
    go up ``non_blocking`` through the next of two pinned staging slots,
    each grown to the level-0 cap when a scene outgrows it; elsewhere by a
    plain copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self._slots = []   # [pinned rows, pinned perm, copied event] x 2
        self._slot = 0

    def _upload(self, rows: torch.Tensor, perm: torch.Tensor, cap: int):
        if self.device.type != "cuda":
            return rows.to(self.device), perm.to(self.device)
        if not self._slots:
            self._slots = [[None, None, torch.cuda.Event()] for _ in range(2)]
        self._slot ^= 1
        slot = self._slots[self._slot]
        slot[2].synchronize()  # this slot's previous copy has finished
        n = len(perm)
        if slot[0] is None or len(slot[0]) < n:   # caps only grow
            slot[0] = torch.empty((cap,) + rows.shape[1:], dtype=rows.dtype,
                                  pin_memory=True)
            slot[1] = torch.empty(cap, dtype=perm.dtype, pin_memory=True)
        host_rows, host_perm = slot[0][:n], slot[1][:n]
        host_rows.copy_(rows)
        host_perm.copy_(perm)
        out = (host_rows.to(self.device, non_blocking=True),
               host_perm.to(self.device, non_blocking=True))
        slot[2].record(torch.cuda.current_stream(self.device))
        return out

    def __call__(self, feat_3d: Optional[np.ndarray], perm: np.ndarray,
                 cap0: int, dim: int) -> torch.Tensor:
        """``feat_3d``: the scene's ``(n, D)`` fused features in voxel
        order (None: the scene has none, all rows zero)."""
        out = torch.zeros((cap0, dim), dtype=torch.float16,
                          device=self.device)
        if feat_3d is not None:
            rows = torch.from_numpy(np.ascontiguousarray(feat_3d,
                                                         dtype=np.float16))
            rows, idx = self._upload(rows, torch.from_numpy(perm), cap0)
            torch.index_select(rows, 0, idx, out=out[:len(perm)])
        return out


class ZeroShotEvaluator:
    def __init__(self, cfg: Config, model: Optional[MinkUNet] = None,
                 text_features: Optional[np.ndarray] = None,
                 allow_pseudo_text: bool = False, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh_for("evaluate", cfg.data_parallel,
                             device=self.device)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.dim = (int(np.asarray(text_features).shape[1])
                    if text_features is not None
                    else output_dim(cfg.feature_2d_extractor))
        self.labelset_name = cfg.labelset or dataset_name_from_root(cfg.data_root)
        labels, palette, mapper = labelset_and_palette(
            self.labelset_name, cfg.map_nuscenes_details)
        self.class_labels, self.palette, self.mapper = labels, palette, mapper
        if text_features is None:
            text_features = extract_text_features(
                labels, cfg.feature_2d_extractor, cfg.data_root,
                cfg.prompt_eng, cfg.text_embedding_cache,
                embedding_file=cfg.embedding_file,
                allow_pseudo=allow_pseudo_text or cfg.allow_pseudo_text,
                dataset_name=self.labelset_name)
        self.text = torch.as_tensor(
            np.asarray(text_features, dtype=np.float32), device=self.device)
        # reference appends 'unlabeled' AFTER text extraction
        self.labelset_full = labels + ["unlabeled"]
        self.mode = cfg.feature_type
        if self.mode != "fusion" and model is None:
            raise ValueError(f"feature_type={self.mode!r} needs a model")
        self.model = None if model is None else model.to(self.device).eval()
        self.geometry = SceneGeometry(cfg, self.device, self.mesh)
        self.place_fused = FusedPlacement(self.device)
        self.want_vis = cfg.vis_input or cfg.vis_pred or cfg.vis_gt
        self.step = make_eval_step(self.mode,
                                   constant_input=not cfg.input_color)
        self.mark_unknown = (cfg.mark_no_feature_to_unknown
                             and self.mode == "fusion")

    def _loader(self) -> FusedFeatureLoader:
        return FusedFeatureLoader(
            datapath_prefix=self.cfg.data_root,
            datapath_prefix_feat=self.cfg.data_root_2d_fused_feature,
            voxel_size=self.cfg.voxel_size, split=self.cfg.split, aug=False,
            memcache=self.cfg.use_shm, eval_all=True, identifier=6797,
            input_color=self.cfg.input_color)

    def run(self, save_features_to: str = "") -> Dict[str, float]:
        cfg = self.cfg
        loader = self._loader()
        n_scenes = len(loader.data_paths)
        is_nuscenes = "nuscenes" in self.labelset_name
        results: Dict[str, float] = {}
        store: Optional[List[np.ndarray]] = None
        rng = np.random.default_rng(cfg.manual_seed)

        step = self.step
        if save_features_to:
            step = make_eval_step(self.mode,
                                  constant_input=not cfg.input_color,
                                  return_features=True)
            os.makedirs(save_features_to, exist_ok=True)
        if self.want_vis:
            os.makedirs(cfg.save_folder, exist_ok=True)

        need_model = self.mode != "fusion"
        for rep in range(cfg.test_repeats):
            if rep > 0:
                loader.reseed(int(rng.integers(10000)))
            preds, gts, masks = [], [], []
            t0 = time.time()
            # host voxelize/assemble test_workers threads ahead of the device
            rounds = rank_scene_rounds(
                loader.get, n_scenes, self.mesh,
                self.geometry if need_model else None, cfg.test_workers)
            rows = self._host_rows(self._scene_outputs(rounds, step), loader,
                                   save_features_to if rep == 0 else "",
                                   vis=self.want_vis and rep == 0)
            for i, logits, pmask, label in rows:
                if is_nuscenes:  # evaluation points are a labeled subset
                    keep = label != 255
                    label, logits, pmask = label[keep], logits[keep], pmask[keep]
                preds.append(logits)
                gts.append(label)
                masks.append(pmask)
            log.info("repeat %d/%d: %d scenes in %.1fs", rep + 1,
                     cfg.test_repeats, n_scenes, time.time() - t0)

            if not cfg.eval_iou:
                # no-GT datasets (Replica): feature export only
                results["miou"] = float("nan")
                return results
            if not self.is_main:  # rank 0 holds every scene's rows
                continue

            with span("eval.miou"):
                gt = np.concatenate(gts)
                mask = np.concatenate(masks)
                pred_logits = preds
                if store is None:
                    store = [p.copy() for p in pred_logits]
                elif rep > 0:
                    for s, p in zip(store, pred_logits):
                        s += p

                cur = self._metric(np.concatenate(pred_logits), gt, mask)
                results[f"repeat_{rep}"] = cur
                if cfg.test_repeats > 1:
                    acc = self._metric(np.concatenate(store), gt, mask)
                    results["accumulated"] = acc
                    log.info("repeat %d mIoU=%.4f accumulated mIoU=%.4f",
                             rep + 1, cur, acc)
                else:
                    results["accumulated"] = cur
                    log.info("mIoU=%.4f", cur)
        if self.is_main:
            results["miou"] = results["accumulated"]
        if self.mesh is not None:
            results = broadcast_from_main(results, self.mesh)
        return results

    def _scene_outputs(self, rounds, step):
        """Yield (scene_idx, sample, step_outputs, n_points), one scene at a
        time on the evaluator's device, for the scenes of ``rounds``
        (:func:`rank_scene_rounds`); a round without a scene for this rank
        yields ``(i, None, None, 0)``."""
        for i, sample, caps in rounds:
            if sample is None:
                yield i, None, None, 0
                continue
            out, n_points = self.scene(sample, step, caps)
            yield i, sample, out, n_points

    def _host_rows(self, outputs, loader, save_features_to: str = "",
                   vis: bool = False):
        """``(scene_idx, point logits fp32, feature mask, labels)`` as host
        arrays, in scene order, of :meth:`_scene_outputs`' ``outputs``;
        writes the scenes' feature files to ``save_features_to`` and, with
        ``vis``, their exports (:meth:`_visualize`).  Under a mesh each
        rank writes the files of its own scenes; rank 0 gets every rank's
        rows, gathered round by round, and the other ranks none."""
        for i, sample, out, n_pts in outputs:
            row = None
            if sample is not None:
                with span("eval.host_rows"):
                    logits = out[0][:n_pts].float().cpu().numpy()
                    pmask = out[1][:n_pts].cpu().numpy() > 0.5
                    label = np.asarray(sample.labels[:n_pts])
                if save_features_to:
                    # per-point FEATURE dump (reference run/evaluate.py:
                    # 302-331), saved before any nuScenes point subsetting,
                    # named by scene (run/evaluate.py:329)
                    scene_name = os.path.basename(
                        str(loader.data_paths[i])).rsplit(".", 1)[0]
                    feat_dtype = (np.float32 if self.mode == "distill"
                                  else np.float16)
                    np.save(join(save_features_to,
                                 f"{scene_name}_openscene_feat_{self.mode}.npy"),
                            out[2][:n_pts].float().cpu().numpy()
                            .astype(feat_dtype))
                if vis:
                    self._visualize(i, sample, logits, label, pmask, loader)
                row = (i, logits, pmask, label)
            if self.mesh is None:
                yield row
                continue
            for r in gather_to_main(row, self.mesh) or ():
                if r is not None:
                    yield r

    def _visualize(self, i: int, sample, logits: np.ndarray,
                   label: np.ndarray, pmask: np.ndarray, loader) -> None:
        """vis_input / vis_pred / vis_gt exports of scene ``i``
        (run/evaluate.py:343-376; the JAX evaluator's ``_visualize``):
        per-point clouds at voxel-grid positions, label-palette coloured,
        with legend sidecars; no-feature and ignored points take the
        'unlabeled' slot.  nuScenes exports its labelled points only, as
        its metric reads them."""
        from ..data.scene_io import load_scene
        from ..utils.viz import (export_labeled_cloud, export_pointcloud,
                                 visualize_labels)
        cfg = self.cfg
        folder = cfg.save_folder
        unl = len(self.class_labels)  # 'unlabeled' palette slot
        keep = None
        if "nuscenes" in self.labelset_name:
            keep = label != 255
            logits, label, pmask = logits[keep], label[keep], pmask[keep]
        pcl = np.asarray(sample.coords, dtype=np.float32)[
            np.asarray(sample.inds_reconstruct)]
        if keep is not None:
            pcl = pcl[keep]
        if cfg.vis_input:
            _, colors, _ = load_scene(str(loader.data_paths[i]))
            if keep is not None:
                colors = colors[keep]
            export_pointcloud(join(folder, f"{i}_input.ply"), pcl,
                              (np.asarray(colors) + 1) / 2)
        if cfg.vis_pred:
            pred = logits.argmax(1)
            if self.mapper is not None:
                pred = self.mapper[pred]
            if self.mark_unknown:
                pred = np.where(pmask, pred, unl)
            export_labeled_cloud(join(folder, f"{i}_{self.mode}.ply"), pcl,
                                 pred, self.palette)
            visualize_labels(sorted(int(u) for u in np.unique(pred)),
                             self.labelset_full, self.palette,
                             join(folder, f"{i}_labels_{self.mode}.jpg"))
        if cfg.vis_gt:
            gt = np.where(label == 255, unl, label)
            export_labeled_cloud(join(folder, f"{i}_gt.ply"), pcl, gt,
                                 self.palette)
            visualize_labels(sorted(int(u) for u in np.unique(gt)),
                             self.labelset_full, self.palette,
                             join(folder, f"{i}_labels_gt.jpg"))

    def scene(self, sample, step, caps=None):
        """``(step outputs, n_points)`` of one scene on its geometry on the
        card (:meth:`SceneGeometry.on_card` on ``caps``; fusion builds
        none), its fused features placed there (:class:`FusedPlacement`)."""
        need_model = self.mode != "fusion"
        need_fused = self.mode != "distill"
        perm = None

        def assemble_raw(caps):
            nonlocal perm
            with span("eval.assemble"):
                raw, caps, perm = assemble_raw_eval_sorted(
                    [sample], self.dim, caps=caps, need_fused=False)
            return raw, caps

        def assemble_host():
            with span("eval.assemble"):
                return assemble_eval_batch([sample], self.dim,
                                           need_model=need_model,
                                           need_fused=need_fused)

        if need_model:
            batch, geo = self.geometry.on_card(assemble_raw, assemble_host,
                                               caps)
        else:
            batch, geo = assemble_host(), None
        if need_fused and isinstance(batch, RawEvalBatch):
            with span("eval.place_fused"):
                batch = batch._replace(feat_3d=self.place_fused(
                    sample.feat_3d, perm, len(batch.mask), self.dim))
        with span("eval.step"):
            out = step(self.model, self.text, batch, geo)
        return out, batch.num_points

    def _metric(self, logits: np.ndarray, gt: np.ndarray,
                mask: np.ndarray) -> float:
        pred = logits.argmax(1)
        if self.mapper is not None:
            pred = self.mapper[pred]
        if self.mark_unknown:
            pred = np.where(mask, pred, NO_FEATURE_ID)
        return metrics.evaluate(pred, gt, dataset=self.labelset_name,
                                stdout=False)


def is_url(path: str) -> bool:
    """Reference run/evaluate.py:59-61."""
    scheme = str(path).split("://", 1)[0].lower() if "://" in str(path) else ""
    return scheme in ("http", "https")


def fetch_checkpoint(url: str, cache_dir: str = "") -> str:
    """Download-and-cache a checkpoint URL (the reference's
    ``model_zoo.load_url``, run/evaluate.py:166-168); returns the local
    path.  Cached under ``~/.cache/openscene_tpu_torch/checkpoints`` keyed
    by file name; a cached file is used without any network access.
    Raises ``RuntimeError`` when the download fails (a host with no
    network)."""
    import urllib.error
    import urllib.request
    cache_dir = cache_dir or os.path.expanduser(
        "~/.cache/openscene_tpu_torch/checkpoints")
    os.makedirs(cache_dir, exist_ok=True)
    local = join(cache_dir, os.path.basename(url))
    if os.path.isfile(local):
        return local
    log.info("downloading %s -> %s", url, local)
    tmp = local + ".part"
    try:
        urllib.request.urlretrieve(url, tmp)
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"could not download checkpoint {url} ({e}); on a host without "
            f"network, download it elsewhere and pass the local path (or "
            f"place it at {local})") from e
    os.replace(tmp, local)
    return local


def load_model_for_eval(cfg: Config, device=None) -> Optional[MinkUNet]:
    """Model init + checkpoint load (skipped entirely in fusion mode,
    run/evaluate.py:164-165); the weights as :func:`load_weights` reads
    ``cfg.model_path``, random from ``cfg.manual_seed`` without a path."""
    if cfg.feature_type == "fusion":
        return None
    dev = resolve_device(device)
    model = build_disnet(cfg, torch.Generator().manual_seed(cfg.manual_seed))
    load_weights(model, cfg)
    return model.to(dev).eval()


def load_weights(model: MinkUNet, cfg: Config) -> None:
    """Load ``cfg.model_path`` into ``model`` (nothing without a path).

    The path may be a checkpoint of the JAX package (flax msgpack:
    ``params``/``state`` through ``convert.params_from_jax``), a reference
    ``.pth(.tar)`` checkpoint with MinkowskiEngine names (converted), a
    torch file holding the port's own ``MinkUNet`` state_dict (loaded as
    is), or a checkpoint written by the port's trainers (its ``"model"``
    entry); an http(s) URL is fetched into the cache first
    (:func:`fetch_checkpoint`) and then read as a local path."""
    from ..convert import params_from_jax
    path = cfg.model_path
    if not path:
        return
    if is_url(path):
        path = fetch_checkpoint(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    payload, is_flax = read_checkpoint(path)
    if is_flax:
        model.load_state_dict(params_from_jax(payload["params"],
                                              payload["state"], cfg.arch_3d))
        log.info("loaded JAX checkpoint %s (epoch %s)", path,
                 payload.get("epoch"))
        return
    sd = payload
    if isinstance(payload, dict):
        sd = payload.get("model", payload.get("state_dict", payload))
    if set(sd) == set(model.state_dict()):
        model.load_state_dict(sd)
        log.info("loaded port state_dict %s", path)
        return
    from ..utils.convert_checkpoint import convert_state_dict
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    order = cfg.region_order or "x_fastest"
    params, state = convert_state_dict(sd, cfg.arch_3d, region_order=order)
    model.load_state_dict(params_from_jax(params, state, cfg.arch_3d))
    log.info("converted reference checkpoint %s (region order %s)", path,
             order)


def evaluate(cfg: Config, device=None) -> Dict[str, float]:
    """One rank's evaluation (``main``'s work on every rank)."""
    model = load_model_for_eval(cfg, device)
    ev = ZeroShotEvaluator(cfg, model, device=device)
    out_dir = cfg.save_folder if cfg.save_feature_as_numpy else ""
    results = ev.run(save_features_to=out_dir)
    log.info("final mIoU: %.4f", results["miou"])
    return results


def main(argv=None):
    cfg, device = load_cli(argv if argv is not None else sys.argv[1:])
    return launch.run(evaluate, cfg, device)


if __name__ == "__main__":
    main()
