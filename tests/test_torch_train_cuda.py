"""Pieces of the train step on the card.  Imports no JAX; skips without
CUDA.

* ``sparse/ops.py:MaskedBatchNormFn`` (the plain Function: the CPU path
  and the kernels' oracle) in bf16 against the plain ops' autograd
  (``masked_batch_norm_plain``): the forward, the running statistics,
  ``dx``, ``dgamma`` and ``dbeta`` bit-equal with the card's own
  reductions; ``dx`` zero at padded rows.
* The training BatchNorm's CUDA kernels (``sparse/batch_norm.py``, the
  card's route of ``masked_batch_norm``) against the plain ops' autograd
  at tolerances of the order of their fp32 sums, with and without the
  ReLU, in bf16 and fp32, from 1 to 1,024 channels and 1 to 61,300 valid
  rows: padded rows of ``out`` and ``dx`` exactly zero, two runs
  bit-equal, 3 launches each way; a strided cotangent; what they refuse.
* ``data/batch.py:_target_buffer``: a train batch's fp16 targets are
  zeroed page-locked memory, so the step's upload is one DMA, also when
  loader threads assemble batches at once.

    python -m pytest tests/test_torch_train_cuda.py -q
"""

import pytest
import torch

from openscene_tpu_torch.data import batch
from openscene_tpu_torch.scripts import dev_bn_bench
from openscene_tpu_torch.sparse import batch_norm, ops


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _plain_fn(x, mask, num, gamma, beta, running_mean, running_var, *,
              train):
    """``MaskedBatchNormFn`` with ``masked_batch_norm``'s signature."""
    n = float(max(num, 1))
    out, mean, var = ops.MaskedBatchNormFn.apply(x, mask, n, gamma, beta,
                                                 1e-5)
    return (out,) + ops._running(mean, var, n, running_mean, running_var,
                                 0.1)


def _bn_run(fn, x, mask, num, gamma, beta, dy):
    x = x.clone().requires_grad_()
    g, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    rm, rv = torch.full_like(gamma, 0.3), torch.full_like(gamma, 1.7)
    out, nm, nv = fn(x, mask, num, g, b, rm, rv, train=True)
    out.backward(dy)
    return out.detach(), nm, nv, x.grad, g.grad, b.grad


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 384])
def test_batch_norm_function_matches_plain_ops_on_the_card(c):
    dev = _card()
    gen = torch.Generator().manual_seed(c)
    cap, num = 70_000, 61_300
    mask = ops.valid_mask(num, cap, device=dev)
    x = ((torch.randn(cap, c, generator=gen).to(dev) * 2 + 0.5)
         * mask).bfloat16()
    dy = (torch.randn(cap, c, generator=gen).to(dev) * mask).bfloat16()
    gamma = torch.randn(c, generator=gen).to(dev)
    beta = torch.randn(c, generator=gen).to(dev)
    got = _bn_run(_plain_fn, x, mask, num, gamma, beta, dy)
    ref = _bn_run(ops.masked_batch_norm_plain, x, mask, num, gamma, beta, dy)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.count_nonzero(got[3][num:]) == 0


# The tolerances of the kernels against the plain ops, and the reasoning
# behind them, are ``scripts/dev_bn_bench.py``'s, which chip_smoke.py
# holds the kernels to at the main paths' shapes.
SUM_TOL, ULP = dev_bn_bench.SUM_TOL, dev_bn_bench.ULP
BN_WIDTHS = [1, 32, 96, 384, 1024]
BN_ROWS = [(1, 70_000), (5, 70_000), (61_300, 70_000)]


def _bn_inputs(c, num, cap, dtype, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    mask = ops.valid_mask(num, cap, device=dev)
    x = ((torch.randn(cap, c, generator=gen).to(dev) * 2 + 0.5)
         * mask).to(dtype)
    dy = torch.randn(cap, c, generator=gen).to(dev).to(dtype)
    dy[num:] = 1.0  # the kernels read the valid rows only
    gamma = torch.randn(c, generator=gen).to(dev)
    beta = torch.randn(c, generator=gen).to(dev)
    return x, mask, dy, gamma, beta


def _within(got, ref, tol, what):
    gap = (got.double() - ref.double()).abs() - tol
    assert gap.max() <= 0, (f"{what}: exceeds its tolerance by "
                            f"{gap.max().item():.3e} (largest tolerance "
                            f"{tol.max().item():.3e})")


@pytest.mark.cuda
@pytest.mark.parametrize("num,cap", BN_ROWS,
                         ids=[f"num{n}of{c}" for n, c in BN_ROWS])
@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", BN_WIDTHS)
def test_batch_norm_kernels_match_plain_ops_on_the_card(c, dtype, relu, num,
                                                        cap):
    """The kernels' out, running buffers, dx, dgamma and dbeta against
    the plain ops' autograd (``masked_batch_norm_plain``, then
    ``torch.relu``) within the sum-order tolerances of
    ``dev_bn_bench.tolerance_used`` (with the ReLU, the masks held apart
    as it says).  Padded rows of out and dx exactly 0; a second run
    bit-equal; 3 + 3 launches."""
    dev = _card()
    x, mask, dy, gamma, beta = _bn_inputs(c, num, cap, dtype, dev,
                                          seed=c * 7 + num)
    got, launches = dev_bn_bench.kernel_run(x, mask, num, gamma, beta, dy,
                                            relu)
    again, _ = dev_bn_bench.kernel_run(x, mask, num, gamma, beta, dy, relu)
    assert launches == (3, 3)
    for a, b in zip(got, again):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out, rm, rv, dx, dgamma, dbeta = got
    assert out.dtype == dx.dtype == dtype
    assert torch.count_nonzero(out[num:]) == 0
    assert torch.count_nonzero(dx[num:]) == 0
    used = dev_bn_bench.tolerance_used(x, mask, num, dy, gamma, beta, relu,
                                       got)
    assert max(used.values()) <= 1, used


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [32, 4], ids=["rows16B", "rows8B"])
def test_batch_norm_kernels_take_a_strided_cotangent(extra):
    """The decoder's BatchNorm feeds a concatenation, whose gradient
    reaches the backward as a column slice: the kernels read it with its
    row stride.  With 16-byte rows (96 + 32 bf16 columns) the result is
    bit-equal to a contiguous cotangent's; with 96 + 4 the kernels take
    scalar loads and another tiling, within the sum-order tolerances."""
    dev = _card()
    c, num, cap = 96, 61_300, 70_000
    x, mask, _, gamma, beta = _bn_inputs(c, num, cap, torch.bfloat16, dev, 5)
    wide = torch.randn(cap, c + extra, device=dev).bfloat16()
    dy = wide[:, :c]
    assert not dy.is_contiguous()
    got, launches = dev_bn_bench.kernel_run(x, mask, num, gamma, beta, dy,
                                            True)
    ref, _ = dev_bn_bench.kernel_run(x, mask, num, gamma, beta,
                                     dy.contiguous(), True)
    assert launches == (3, 3)
    if extra % 8 == 0:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        return
    dx, dx_ref = got[3].double(), ref[3].double()
    _within(dx, dx_ref, ULP[torch.bfloat16] * dx_ref.abs()
            + 8 * SUM_TOL * dx_ref.abs().max(), "dx")
    for a, b, what in ((got[4], ref[4], "dgamma"), (got[5], ref[5],
                                                      "dbeta")):
        _within(a, b, SUM_TOL * 4 * b.abs().max(), what)
    assert torch.count_nonzero(got[3][num:]) == 0


@pytest.mark.cuda
def test_batch_norm_kernels_refuse_what_they_do_not_take():
    """On the card the training route launches the kernels or raises:
    fp16 and fp64 activations, a non-contiguous input and non-fp32
    parameters are refused, with no launch."""
    dev = _card()
    c, num, cap = 32, 50, 64
    mask = ops.valid_mask(num, cap, device=dev)
    gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    before = batch_norm.masked_bn_fwd.launches
    x = torch.randn(cap, c, device=dev)
    for bad, err in ((x.half(), TypeError), (x.double(), TypeError),
                     (x.t().contiguous().t(), ValueError)):
        with pytest.raises(err):
            ops.masked_batch_norm(bad, mask, num, gamma, beta, rm, rv,
                                  train=True)
    with pytest.raises(TypeError):
        ops.masked_batch_norm(x, mask, num, gamma.double(), beta, rm, rv,
                              train=True)
    assert batch_norm.masked_bn_fwd.launches == before


@pytest.mark.cuda
def test_targets_are_page_locked():
    dev = _card()
    buf = batch._target_buffer(1000, 768)
    assert buf.shape == (1000, 768) and not buf.any()
    t = torch.from_numpy(buf)
    assert t.is_pinned()
    buf[3] = 1.5
    assert float(t.to(dev)[3].sum()) == 1.5 * 768


@pytest.mark.cuda
def test_targets_from_loader_threads():
    """The trainer's loader threads assemble batches at once: each
    thread's buffers are page-locked, zeroed and its own."""
    from concurrent.futures import ThreadPoolExecutor
    _card()

    def make(i):
        buf = batch._target_buffer(2000 + i, 768)
        ok = torch.from_numpy(buf).is_pinned() and not buf.any()
        buf[:] = i
        return ok, buf

    with ThreadPoolExecutor(4) as pool:
        out = list(pool.map(make, range(8)))
    for i, (ok, buf) in enumerate(out):
        assert ok and buf.shape == (2000 + i, 768) and (buf == i).all()
