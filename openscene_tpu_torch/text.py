"""CLIP text-embedding provider with on-disk cache.

The reference extracts CLIP text features for a labelset with prompt
engineering ("a {label} in a scene") and caches them to disk
(``util/util.py:24-66``, ``run/distill.py:254-292``).  CLIP models
(ViT-L/14@336px for openseg -> 768-d, ViT-B/32 for lseg -> 512-d) are frozen
external teachers; this provider resolves embeddings from, in order:

1. an explicit embedding file (``.npy``/``.npz``/torch ``.pt``),
2. the on-disk cache (same naming scheme as the reference),
3. a live CLIP text encoder via HuggingFace ``transformers`` if the weights
   are available locally (no-network environments skip this),
4. deterministic unit-norm pseudo-embeddings (test/bench fallback — flagged
   loudly, never silently used for real evaluation unless allowed).
"""

from __future__ import annotations

import hashlib
import logging
import os
from os.path import exists, join
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

CLIP_MODELS = {"openseg": ("ViT-L/14@336px", 768), "lseg": ("ViT-B/32", 512)}
_HF_NAMES = {"ViT-L/14@336px": "openai/clip-vit-large-patch14-336",
             "ViT-B/32": "openai/clip-vit-base-patch32"}


def clip_model_for_extractor(extractor: str):
    for key, (name, dim) in CLIP_MODELS.items():
        if key in extractor:
            return name, dim
    raise NotImplementedError(extractor)


def apply_prompt_engineering(labelset: Sequence[str], data_root: str = "",
                             prompt_eng: bool = True) -> List[str]:
    """"a {label} in a scene", with the reference's dataset-specific 'other'
    fixups (util/util.py:48-58)."""
    labels = list(labelset)
    if prompt_eng:
        labels = [f"a {l} in a scene" for l in labels]
        if "scannet_3d" in data_root:
            labels[-1] = "other"
        if "matterport_3d" in data_root:
            labels[-2] = "other"
    return labels


def pseudo_embeddings(labels: Sequence[str], dim: int) -> np.ndarray:
    """Deterministic unit-norm embedding per label string (hash-seeded)."""
    out = np.zeros((len(labels), dim), dtype=np.float32)
    for i, lab in enumerate(labels):
        seed = int.from_bytes(hashlib.sha256(lab.encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
        out[i] = v / np.linalg.norm(v)
    return out


def _load_embedding_file(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        return np.load(path)["embeddings"]
    import torch
    return torch.load(path, map_location="cpu", weights_only=False
                      ).detach().float().numpy()


_HF_UNAVAILABLE: set = set()  # model names that failed to load this process


def _try_hf_clip(model_name: str, labels: Sequence[str]) -> Optional[np.ndarray]:
    if model_name in _HF_UNAVAILABLE:
        return None
    try:
        from transformers import CLIPModel, CLIPTokenizer  # noqa: deferred
        hf = _HF_NAMES[model_name]
        tok = CLIPTokenizer.from_pretrained(hf, local_files_only=True)
        model = CLIPModel.from_pretrained(hf, local_files_only=True)
    except Exception as e:  # no local weights / no transformers: remember —
        # interactive consumers (demo/viewer.py) call per query and the
        # import + disk scan is slow the first time
        _HF_UNAVAILABLE.add(model_name)
        log.info("CLIP text encoder unavailable (%s)", e)
        return None
    import torch
    with torch.no_grad():
        inputs = tok(list(labels), padding=True, return_tensors="pt")
        feats = model.get_text_features(**inputs)
        feats = feats / feats.norm(dim=-1, keepdim=True)
    return feats.float().numpy()


def extract_image_features_from_folder(folder: str,
                                       model_name: str = "ViT-L/14@336px"
                                       ) -> np.ndarray:
    """L2-normalized CLIP image embeddings for every image in a folder
    (reference util/util.py:68-84); requires local HF CLIP weights."""
    import glob as _glob

    from PIL import Image
    from transformers import CLIPModel, CLIPProcessor
    import torch

    hf = _HF_NAMES[model_name]
    proc = CLIPProcessor.from_pretrained(hf, local_files_only=True)
    model = CLIPModel.from_pretrained(hf, local_files_only=True)
    feats = []
    with torch.no_grad():
        for path in sorted(_glob.glob(os.path.join(folder, "*"))):
            image = Image.open(path).convert("RGB")
            inputs = proc(images=image, return_tensors="pt")
            f = model.get_image_features(**inputs)
            feats.append((f / f.norm(dim=-1, keepdim=True)).float().numpy())
    return np.concatenate(feats, axis=0)


def extract_text_features(labelset: Sequence[str], extractor: str = "openseg",
                          data_root: str = "", prompt_eng: bool = True,
                          cache_dir: str = "saved_text_embeddings",
                          embedding_file: str = "",
                          allow_pseudo: bool = False,
                          dataset_name: str = "") -> np.ndarray:
    """(num_labels, dim) L2-normalized float32 text embeddings."""
    model_name, dim = clip_model_for_extractor(extractor)
    labels = apply_prompt_engineering(labelset, data_root, prompt_eng)

    if embedding_file:
        emb = _load_embedding_file(embedding_file).astype(np.float32)
        assert emb.shape == (len(labels), dim), (emb.shape, len(labels), dim)
        return emb

    cache = None
    if cache_dir:
        tag = dataset_name or hashlib.sha1(
            ("|".join(labels)).encode()).hexdigest()[:10]
        cache = join(cache_dir, f"clip_{tag}_labels_{dim}.npz")
        if exists(cache):
            with np.load(cache, allow_pickle=False) as blob:
                provenance = str(blob["provenance"]) if "provenance" in blob \
                    else "unstamped"
                emb = blob["embeddings"].astype(np.float32)
            if provenance != "clip":
                # A pseudo/unstamped cache must never silently stand in for
                # CLIP space (the reference caches genuine CLIP outputs only,
                # run/distill.py:283-290).  Refuse in real mode.
                if not allow_pseudo:
                    raise RuntimeError(
                        f"Text-embedding cache {cache} has provenance "
                        f"'{provenance}', not 'clip'. Refusing to use it for "
                        "real evaluation: delete it, pass embedding_file=, "
                        "or set allow_pseudo=True (tests/benchmarks only).")
                log.warning("Using %s-provenance cached text embeddings from "
                            "%s (allow_pseudo set) — not CLIP space.",
                            provenance, cache)
            return emb

    emb = _try_hf_clip(model_name, labels)
    if emb is not None:
        if cache:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(cache, embeddings=emb, labels=np.asarray(labels),
                     provenance=np.asarray("clip"))
        return emb

    if not allow_pseudo:
        raise RuntimeError(
            "No CLIP text encoder or cached embeddings available; pass "
            "embedding_file=, pre-populate the cache, or set "
            "allow_pseudo=True (tests/benchmarks only).")
    log.warning("Using PSEUDO text embeddings — not CLIP space; only "
                "valid for synthetic pipelines. (Never written to the "
                "shared cache dir.)")
    return pseudo_embeddings(labels, dim)
