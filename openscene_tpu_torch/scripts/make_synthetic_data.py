"""Write the synthetic smoke-test dataset tree that
``configs/synthetic/smoke.yaml`` reads (``data/synthetic`` by default).

Counterpart of ``scripts/make_synthetic_data.py`` of the JAX package, over
the port's copy of ``data/synthetic.build_synthetic_dataset``: the same
flags, defaults and files.  The tree is not committed (about 400 MB of
fabricated scenes at the defaults); run once per checkout::

    python -m openscene_tpu_torch.scripts.make_synthetic_data

Layout (what ``data/loaders.py`` reads)::

    <root>/scannet_3d/{train,val}/scene*.npz
    <root>/scannet_multiview/scene*_{k}.npz
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..data.synthetic import build_synthetic_dataset


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="data/synthetic")
    ap.add_argument("--n_train", type=int, default=2)
    ap.add_argument("--n_val", type=int, default=2)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--density", type=float, default=3000.0,
                    help="points per m^2 of surface (~150k pts/scene at 3000)")
    ap.add_argument("--chunks", type=int, default=2,
                    help="random-chunk feature files per train scene")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    d3, dfeat = build_synthetic_dataset(
        args.root, n_train=args.n_train, n_val=args.n_val, dim=args.dim,
        density=args.density, num_rand_file_per_scene=args.chunks,
        seed=args.seed)
    print(f"wrote {d3} and {dfeat}")
    return d3, dfeat


if __name__ == "__main__":
    main()
