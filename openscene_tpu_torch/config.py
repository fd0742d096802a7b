"""Typed configuration system.

Replaces the reference's attr-dict ``CfgNode`` (``util/config.py:8-90`` in
the reference) and its scattered ``hasattr`` defaults with one typed
dataclass.  Behavioral parity points:

* YAML section headers (``DATA:``, ``DISTILL:``, ``TEST:`` ...) are cosmetic —
  all keys are flattened into a single namespace
  (reference ``util/config.py:68-70``).
* CLI overrides are positional ``key value`` pairs; values are parsed with
  ``ast.literal_eval`` falling back to string, and only the last dotted
  component of the key is matched (reference ``util/config.py:76-108``).
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple



@dataclass
class Config:
    # ---- DATA ----
    data_root: str = "data/scannet_3d"
    data_root_2d: str = ""
    data_root_2d_fused_feature: str = ""
    feature_2d_extractor: str = "openseg"  # 'openseg' (768-d) | 'lseg' (512-d)
    classes: int = 20
    aug: bool = True
    voxel_size: float = 0.02
    input_color: bool = False
    use_shm: bool = False  # reference's SharedArray cache; here: in-RAM scene cache

    # ---- DISTILL / TRAIN ----
    arch_3d: str = "MinkUNet18A"
    ignore_label: int = 255
    train_gpu: List[int] = field(default_factory=lambda: [0])
    workers: int = 2
    batch_size: int = 8
    batch_size_val: int = 1
    base_lr: float = 1e-4
    lr_multiplier: float = 10.0  # reference applies 10x to every param group
    # because index_split=0 (run/distill.py:142,344-347)
    loss_type: str = "cosine"  # 'cosine' | 'l1'
    loop: int = 5
    epochs: int = 100
    start_epoch: int = 0
    power: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 1e-4
    manual_seed: int = 1463
    print_freq: int = 10
    save_freq: int = 1
    save_path: str = "out/exp"
    resume: str = ""
    evaluate: bool = True
    eval_freq: int = 1
    sync_bn: bool = False

    # ---- TEST ----
    split: str = "val"
    prompt_eng: bool = True
    mark_no_feature_to_unknown: bool = True
    feature_type: str = "ensemble"  # 'distill' | 'fusion' | 'ensemble'
    save_feature_as_numpy: bool = False
    vis_input: bool = False
    vis_pred: bool = False
    vis_gt: bool = False
    test_workers: int = 2
    test_gpu: List[int] = field(default_factory=lambda: [0])
    test_batch_size: int = 1
    test_repeats: int = 5
    eval_iou: bool = True
    model_path: str = ""
    save_folder: str = "out/eval"
    labelset: str = ""  # override labelset name (else derived from data_root)
    map_nuscenes_details: bool = False

    # ---- Distributed: one process per GPU (parallel/mesh.py) ----
    # data-axis ranks; -1: every rank of the process group (the trainers
    # cap it at batch_size); > 1 without a process group: the entry
    # points' main starts that many local processes
    data_parallel: int = -1
    # ranks that split the distill head's D (must divide it); distill only
    model_parallel: int = 1
    dist_url: str = ""  # accepted and ignored (reference compat)
    dist_backend: str = ""  # accepted and ignored (reference compat)
    multiprocessing_distributed: bool = False  # accepted and ignored
    world_size: int = 1  # accepted and ignored: num_processes or torchrun
    rank: int = 0  # accepted and ignored: process_id or torchrun
    # multi-host without torchrun: "host:port" of rank 0 (a tcp:// process
    # group), the number of processes (GPUs) and this process's rank
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    # ---- Engine knobs (no reference equivalent) ----
    compute_dtype: str = "bfloat16"  # matmul dtype inside the sparse engine
    bucket_growth: float = 1.3  # geometric capacity bucket ratio
    min_bucket: int = 4096  # smallest voxel-capacity bucket
    use_native_builder: bool = True  # unused: as in the JAX package, the
    # host planner takes the C++ builder wherever g++ builds it
    region_order: str = ""  # ME kernel-region order for reference-checkpoint
    # conversion ("x_fastest"/"z_fastest"; "" = x_fastest default)
    text_embedding_cache: str = "saved_text_embeddings"
    embedding_file: str = ""  # explicit text-embedding file (.npy/.npz/.pt)
    allow_pseudo_text: bool = False  # hash-seeded pseudo embeddings (tests)
    # training-side knobs of the JAX package, kept so configs load unchanged
    memory_efficient_loss: bool = False
    device_geometry: str = "auto"
    grid_dims0: Tuple[int, int, int] = ()
    grid_overflow_limit: int = 3

    def copy(self, **updates: Any) -> "Config":
        return dataclasses.replace(self, **updates)


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _decode_value(v: str) -> Any:
    """literal_eval with string fallback (reference util/config.py:93-108)."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(value: Any, target_type: type, key: str) -> Any:
    if target_type is float and isinstance(value, int):
        return float(value)
    if target_type is bool and isinstance(value, int):
        return bool(value)
    if target_type is str and value is None:
        return ""
    # tuple<->list casting (reference util/config.py:111-146)
    if isinstance(value, tuple):
        return list(value)
    return value


def load_config(path: Optional[str] = None, overrides: Tuple[str, ...] = ()) -> Config:
    """Load a YAML config (sections flattened) and apply CLI overrides."""
    flat = {}
    if path:
        import yaml  # only a YAML file needs PyYAML
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        for section, body in raw.items():
            if isinstance(body, dict):
                flat.update(body)
            else:
                flat[section] = body
    if len(overrides) % 2 != 0:
        raise ValueError(f"overrides must be key/value pairs, got {overrides}")
    for k, v in zip(overrides[::2], overrides[1::2]):
        # only the last dotted component matters (reference util/config.py:82-83)
        flat[k.split(".")[-1]] = _decode_value(v)

    cfg = Config()
    for k, v in flat.items():
        if k not in _FIELDS:
            # Unknown keys are kept silently for forward compat (the reference
            # accepts arbitrary keys); stash them as attributes.
            object.__setattr__(cfg, k, _decode_value(v) if isinstance(v, str) else v)
            continue
        f = _FIELDS[k]
        v = _decode_value(v) if isinstance(v, str) and f.type not in ("str", str) else v
        setattr(cfg, k, _coerce(v, f.type if isinstance(f.type, type) else type(getattr(cfg, k)), k))
    return cfg


def load_cli(argv) -> Tuple[Config, Optional[str]]:
    """``(config, device)`` of an entry point's arguments ``--config <yaml>
    [--device cuda|cpu] [key value]*`` (``device`` None when not given)."""
    cfg_path, device, rest = None, None, []
    it = iter(argv)
    for a in it:
        if a == "--config" or a.startswith("--config="):
            cfg_path = a.split("=", 1)[1] if "=" in a else next(it)
        elif a == "--device" or a.startswith("--device="):
            device = a.split("=", 1)[1] if "=" in a else next(it)
        else:
            rest.append(a)
    return load_config(cfg_path, tuple(rest)), device


def dataset_name_from_root(data_root: str) -> str:
    """The reference derives the dataset/labelset name from the directory name
    (run/evaluate.py:217)."""
    return data_root.rstrip("/").split("/")[-1]
