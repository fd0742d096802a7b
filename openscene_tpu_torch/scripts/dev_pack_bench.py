"""Pair-packed transpose on the card: kernel, plain version, one PyTorch call.

Counterpart of ``scripts/dev_pack_bench.py`` of the JAX package.  At its
five shapes (the bench batch's level-0 and level-1 caps at 96, 128 and 256
channels) the CUDA kernel (``sparse/pack.py:pack_pairs_t``), its plain
version and the one call ``x.view(int32).view(cap // 128, 128, C // 2)
.transpose(1, 2).contiguous()`` must give bit-equal words; each is timed
with CUDA events.

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_pack_bench
[--iters 20]``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple

import torch

from ..sparse.pack import ROWS, pack_pairs_t, pack_pairs_t_plain
from .timing import card_line, time_ms

SHAPES = ((1039872, 96), (1039872, 128), (425472, 96), (425472, 256),
          (108544, 256))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def library_pack(x: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call: bf16 rows read as little-endian words."""
    cap, c = x.shape
    return x.view(torch.int32).view(cap // ROWS, ROWS, c // 2) \
        .transpose(1, 2).contiguous()


def bench_pack(shapes: Sequence[Tuple[int, int]] = SHAPES, iters: int = 20,
               device="cuda", seed: int = 0) -> List[Dict]:
    """One row per shape: bit equality of kernel, plain and library, and
    their times in ms, beside the bound (x read once, o written once at
    the H100's 3.35 TB/s).  Raises if any two results differ."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for cap, c in shapes:
        x = torch.randn((cap, c), generator=gen, device=device).to(
            torch.bfloat16)
        got, plain, lib = pack_pairs_t(x), pack_pairs_t_plain(x), \
            library_pack(x)
        equal = torch.equal(got, plain) and torch.equal(got, lib)
        if not equal:
            raise AssertionError(f"pack ({cap}, {c}): kernel, plain and "
                                 "library words differ")
        nbytes = 2 * cap * c * 2
        rows.append({
            "shape": (cap, c), "equal": equal,
            "ms": time_ms(lambda: pack_pairs_t(x), device, iters),
            "plain_ms": time_ms(lambda: pack_pairs_t_plain(x), device,
                                max(iters // 4, 1)),
            "library_ms": time_ms(lambda: library_pack(x), device, iters),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "device": str(x.device)})
        del x, got, plain, lib
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dev_pack_bench needs a CUDA device")
    name = card_line()
    for r in bench_pack(iters=args.iters):
        print(f"({r['shape'][0]:8d},{r['shape'][1]:4d})  kernel "
              f"{r['ms']:8.4f} ms  plain {r['plain_ms']:8.4f} ms  library "
              f"{r['library_ms']:8.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"(bytes)  bit-equal {r['equal']}  [{name}]", flush=True)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
