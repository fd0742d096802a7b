"""Training masked BatchNorm on the card: kernels, plain Function, library.

At the main paths' shapes (a train batch's level-0 and level-4 rows at the
BatchNorm widths of MinkUNet18A and MinkUNet101), one forward and backward
with the ReLU (``relu=True``, as the model's ``bn1``/``bn2`` run it) through

* the CUDA kernels (``sparse/batch_norm.py``, the port's route);
* the plain Function that precedes them (``sparse/ops.py:
  MaskedBatchNormFn`` and ``torch.relu``), the CPU path and oracle;
* ``torch.nn.functional.batch_norm`` on the valid rows and
  ``torch.relu``: the library yardstick, timed here only and never
  called by the port.

Device ms of each (the host's enqueue hidden behind a sleep kernel), the
kernels' forward and backward alone, the bound (5 bf16 passes over the
valid ``(num, C)``: ``benchmark/counts_bottleneck.py:norm_ms``) and its
share.  It raises unless every output of the kernels (out, running
buffers, ``dx``, ``dgamma``, ``dbeta``) lies within its sum-order
tolerance of the plain ops' autograd (:func:`tolerance_used`, which the
card's tests share), two runs are bit-equal and each direction makes 3
launches.

Run on the card: ``python -m openscene_tpu_torch.scripts.dev_bn_bench
[--iters 20]``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple

import torch

from ..sparse import batch_norm, ops
from .timing import card_line, device_time_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# (model and level, C, num, cap): the seg and distill cells' level-0 and
# level-4 caps (PERF.md §4) with about 90% and 85% of them valid
SHAPES = (("18A L0", 32, 1_000_000, 1_115_648),
          ("18A L0", 96, 1_000_000, 1_115_648),
          ("18A L4", 256, 8_000, 9_728),
          ("101 L0", 384, 1_000_000, 1_115_648),
          ("101 L4", 1024, 8_000, 9_728))


def _inputs(c: int, num: int, cap: int, device, gen):
    mask = ops.valid_mask(num, cap, device=device)
    x = ((torch.randn((cap, c), generator=gen, device=device) * 2 + 0.5)
         * mask).bfloat16()
    dy = (torch.randn((cap, c), generator=gen, device=device)
          * mask).bfloat16()
    gamma = torch.randn(c, generator=gen, device=device)
    beta = torch.randn(c, generator=gen, device=device)
    return x, dy, mask, gamma, beta


def _run(route: str, x, dy, mask, num: int, gamma, beta, rm, rv):
    """One forward and backward with the ReLU: (out, dx, dgamma, dbeta)."""
    xx = x.detach().requires_grad_()
    g = gamma.detach().requires_grad_()
    b = beta.detach().requires_grad_()
    if route == "kernels":
        out = ops.masked_batch_norm(xx, mask, num, g, b, rm, rv, train=True,
                                    relu=True)[0]
    elif route == "plain":
        out = torch.relu(ops.MaskedBatchNormFn.apply(
            xx, mask, float(max(num, 1)), g, b, 1e-5)[0])
    else:  # the library yardstick on the valid rows
        out = torch.relu(torch.nn.functional.batch_norm(
            xx[:num], None, None, g, b, training=True, momentum=0.1,
            eps=1e-5))
        dy = dy[:num]
    return (out,) + torch.autograd.grad(out, (xx, g, b), dy)


# Tolerances of the kernels against the plain ops.  Both take the same
# fp32 formulas with the fp32 sums in other orders (Welford and Chan's
# merge over row splits against two-pass sums; the closed-form backward
# against autograd's chain).  Either side's sums run at most 2**10
# dependent additions, each rounding by at most 2**-24 of its running
# magnitude, so the statistics and the per-channel sums differ by at most
# SUM_TOL of the sum of the magnitudes of their terms; an output rounded
# to its dtype from two such fp32 values may differ by one unit in the
# last place of itself (ULP) besides.
SUM_TOL = 2.0 ** -14
ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
RUNNING = (0.3, 1.7)  # the running buffers' values before a checked run


def _used(got, ref, tol) -> float:
    """The largest |got - ref| as a share of its tolerance."""
    return ((got.double() - ref.double()).abs() / tol).max().item()


def tolerance_used(x, mask, num: int, dy, gamma, beta, relu: bool,
                   got) -> Dict[str, float]:
    """Of each output of one run of the kernels, ``got`` = (out, running
    mean, running var, dx, dgamma, dbeta) with the buffers at
    :data:`RUNNING` before it, the largest gap to the plain ops' autograd
    (``masked_batch_norm_plain``, then ``torch.relu``) as a share of its
    tolerance: at most 1 within it.

    With the ReLU the plain backward takes the kernels' own mask
    (``out > 0``): where the two forwards round a value near 0 to
    opposite signs the gradient has a step, so the masks are held apart,
    to agree wherever the plain value is beyond the output's tolerance
    (``relu_mask``: the largest such plain value's share of it)."""
    out, rm, rv, dx, dgamma, dbeta = got
    xx = x.detach().clone().requires_grad_()
    g = gamma.detach().clone().requires_grad_()
    b = beta.detach().clone().requires_grad_()
    ref_out, ref_rm, ref_rv = ops.masked_batch_norm_plain(
        xx, mask, num, g, b, torch.full_like(gamma, RUNNING[0]),
        torch.full_like(gamma, RUNNING[1]), train=True)
    keep = (out > 0) if relu else torch.ones_like(out, dtype=torch.bool)
    ref_out.backward(dy * keep)
    ref_out = ref_out.detach().double()
    ulp = ULP[x.dtype]

    xv = x[:num].double()
    n = float(max(num, 1))
    mag = xv.abs().sum(0) / n                 # the mean's terms
    var = ((xv - xv.mean(0)) ** 2).sum(0) / n
    used = {"running_mean": _used(rm, ref_rm, 0.1 * SUM_TOL * mag + 1e-30),
            "running_var": _used(rv, ref_rv, 0.1 * SUM_TOL * (var + mag ** 2)
                                 * n / max(n - 1, 1) + 1e-30)}
    tol_out = ulp * ref_out.abs() + SUM_TOL * (ref_out.abs().max() + 1e-30)
    if relu:
        flipped = keep != (ref_out > 0)
        used["relu_mask"] = ((ref_out.abs() / tol_out)[flipped].max().item()
                             if flipped.any() else 0.0)
        ref_out = torch.relu(ref_out)
    used["out"] = _used(out, ref_out, tol_out)
    # dx: the closed form's terms are at most |gamma * inv| max|g| and
    # |xhat| (at most about 5 here) times that
    ref_dx = xx.grad.double()
    used["dx"] = _used(dx, ref_dx, ulp * ref_dx.abs() + 8 * SUM_TOL * (
        ref_dx.abs().max() + 1e-30))
    gk = dy[:num].double() * keep[:num]
    xhat = (xv - xv.mean(0)) / torch.sqrt(var + 1e-5)
    used["dbeta"] = _used(dbeta, b.grad, SUM_TOL * gk.abs().sum(0) + 1e-30)
    used["dgamma"] = _used(dgamma, g.grad, 2 * SUM_TOL * (
        (gk * xhat).abs().sum(0) + gk.abs().sum(0)) + 1e-30)
    return used


def kernel_run(x, mask, num: int, gamma, beta, dy, relu: bool):
    """The card's route of ``masked_batch_norm``, forward and backward,
    with the buffers at :data:`RUNNING` before it: (out, running mean,
    running var, dx, dgamma, dbeta) and the (forward, backward) launches
    it made."""
    before = (batch_norm.masked_bn_fwd.launches,
              batch_norm.masked_bn_bwd.launches)
    xx = x.detach().clone().requires_grad_()
    g = gamma.detach().clone().requires_grad_()
    b = beta.detach().clone().requires_grad_()
    rm = torch.full_like(gamma, RUNNING[0])
    rv = torch.full_like(gamma, RUNNING[1])
    out, nm, nv = ops.masked_batch_norm(xx, mask, num, g, b, rm, rv,
                                        train=True, relu=relu)
    if nm is not rm or nv is not rv:
        raise AssertionError("the running buffers were not moved in place")
    out.backward(dy)
    launches = (batch_norm.masked_bn_fwd.launches - before[0],
                batch_norm.masked_bn_bwd.launches - before[1])
    return (out.detach(), rm, rv, xx.grad, g.grad, b.grad), launches


def bench_bn(shapes: Sequence[Tuple[str, int, int, int]] = SHAPES,
             iters: int = 20, device="cuda", seed: int = 0) -> List[Dict]:
    """One row per shape; raises if an output lies outside its tolerance
    of the plain ops (:func:`tolerance_used`), padded rows are not zero,
    two kernel runs differ in a bit or the launches are not 3 forward and
    3 backward."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for what, c, num, cap in shapes:
        x, dy, mask, gamma, beta = _inputs(c, num, cap, device, gen)
        got, launches = kernel_run(x, mask, num, gamma, beta, dy, True)
        again, _ = kernel_run(x, mask, num, gamma, beta, dy, True)
        equal = all(torch.equal(p, q) for p, q in zip(got, again))
        zero = bool(torch.count_nonzero(got[0][num:]) == 0
                    and torch.count_nonzero(got[3][num:]) == 0)
        used = tolerance_used(x, mask, num, dy, gamma, beta, True, got)
        if (not equal or not zero or launches != (3, 3)
                or max(used.values()) > 1):
            raise AssertionError(
                f"bn {what} C={c}: bit-equal {equal}, padded rows zero "
                f"{zero}, launches {launches}, tolerance used {used}")
        rm, rv = got[1].clone(), got[2].clone()
        out, stats = batch_norm.masked_bn_fwd(x, num, gamma, beta, rm, rv,
                                              relu=True)
        nbytes = 5 * num * c * x.element_size()
        row = {
            "shape": f"{what} C={c} num={num} cap={cap}", "c": c, "num": num,
            "cap": cap, "dtype": "bf16", "relu": True,
            "ms": device_time_ms(lambda: _run(
                "kernels", x, dy, mask, num, gamma, beta, rm, rv), iters),
            "fwd_ms": device_time_ms(lambda: batch_norm.masked_bn_fwd(
                x, num, gamma, beta, rm, rv, relu=True), iters),
            "bwd_ms": device_time_ms(lambda: batch_norm.masked_bn_bwd(
                x, dy, stats, gamma, beta, num, relu=True), iters),
            "plain_ms": device_time_ms(lambda: _run(
                "plain", x, dy, mask, num, gamma, beta, rm, rv),
                max(iters // 4, 1)),
            "library_ms": device_time_ms(lambda: _run(
                "library", x, dy, mask, num, gamma, beta, rm, rv), iters),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "tolerance_used": used, "padded_rows_zero": zero,
            "bit_equal": equal, "launches": launches,
            "tiling": batch_norm._tiling(x, num, x)._asdict()}
        row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
        rows.append(row)
        del x, dy, mask, got, again, out, stats
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dev_bn_bench needs a CUDA device")
    name = card_line()
    for r in bench_bn(iters=args.iters):
        print(f"bn {r['shape']}: kernels {r['ms']:.4f} ms (fwd "
              f"{r['fwd_ms']:.4f}, bwd {r['bwd_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} (bytes), {r['roofline_pct']:.1f}% of it, "
              f"at most {max(r['tolerance_used'].values()):.3f} of the "
              f"tolerance used [{name}]", flush=True)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
