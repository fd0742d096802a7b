"""The training BatchNorm and 1x1 conv Functions of ``sparse/ops.py``.

* ``MaskedBatchNormFn`` against the plain ops it replaces
  (``masked_batch_norm_plain``) under autograd, fp32 and bf16 (bf16 on
  the card in ``test_torch_train_cuda.py``): the forward, the running
  statistics, ``dx``, ``dgamma`` and ``dbeta`` bit-equal; ``dx`` exactly
  zero at padded rows.  ``masked_batch_norm`` runs it in training in
  every dtype, and the plain ops in eval.
* ``conv1x1`` against ``matmul_f32(...).to(x.dtype)`` under autograd: the
  same output and ``dx``; ``dW`` the fp32 sum of the products, where the
  plain product's autograd rounds it to x's dtype.
* A bf16 MinkUNet101 training forward (published widths, a tiny scene)
  keeps no fp32 ``(cap, C > 1)`` tensor for its backward: BatchNorm keeps
  the bf16 input and per-channel statistics, the 1x1 convs their bf16
  operands.
* ``relu=True`` on the CPU (training and eval) is ``relu`` of the output
  without it, bit for bit, forward and backward.
* The card's kernel route (``sparse/batch_norm.py``): its Function and
  wrappers run their plain versions on the CPU, without launches, and
  agree with the float64 autograd of the plain ops; the launch shape
  (``tiling``) covers every channel and row and fills the card.
* The sum-order tolerances that hold the kernels to the plain ops on the
  card (``scripts/dev_bn_bench.py:tolerance_used``) pass the kernels'
  plain versions and refuse a planted fault.
"""

import numpy as np
import pytest
import torch

from openscene_tpu_torch.models.sparse_unet import MaskedBatchNorm, MinkUNet
from openscene_tpu_torch.scripts import dev_bn_bench
from openscene_tpu_torch.sparse import batch_norm, ops
from openscene_tpu_torch.sparse.geometry import (GeometryCaps,
                                                 build_unet_geometry,
                                                 geometry_to_device,
                                                 level_counts)
from tests.test_torch_unet import _one_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]


def _bn_fn(x, mask, num, gamma, beta, running_mean, running_var, *,
           train):
    """``MaskedBatchNormFn`` with ``masked_batch_norm``'s signature."""
    out, mean, var = ops.MaskedBatchNormFn.apply(
        x, mask, float(max(num, 1)), gamma, beta, 1e-5)
    return (out,) + ops._running(mean, var, float(max(num, 1)),
                                 running_mean, running_var, 0.1)


def _bn_run(fn, x, mask, num, gamma, beta, dy):
    x = x.clone().requires_grad_()
    g, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    rm, rv = torch.full_like(gamma, 0.3), torch.full_like(gamma, 1.7)
    out, nm, nv = fn(x, mask, num, g, b, rm, rv, train=True)
    out.backward(dy)
    return out.detach(), nm, nv, x.grad, g.grad, b.grad


def _check_bn_bits(dtype, c, device="cpu"):
    """The Function's forward, running statistics and gradients equal the
    plain ops' autograd bit for bit on ``device``; ``dx`` zero at padded
    rows."""
    gen = torch.Generator().manual_seed(c)
    cap, num = 700, 613
    mask = ops.valid_mask(num, cap).to(device)
    x = ((torch.randn(cap, c, generator=gen).to(device) * 2 + 0.5)
         * mask).to(dtype)
    dy = (torch.randn(cap, c, generator=gen).to(device) * mask).to(dtype)
    gamma = torch.randn(c, generator=gen).to(device)
    beta = torch.randn(c, generator=gen).to(device)
    got = _bn_run(_bn_fn, x, mask, num, gamma, beta, dy)
    ref = _bn_run(ops.masked_batch_norm_plain, x, mask, num, gamma, beta, dy)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.count_nonzero(got[3][num:]) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [1, 48, 384])
def test_batch_norm_function_matches_plain_ops(dtype, c):
    _check_bn_bits(dtype, c)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_batch_norm_training_takes_the_function_for_bf16(dtype):
    """Training takes the Function in bf16 and fp32 alike."""
    cap, num, c = 64, 50, 16
    mask = ops.valid_mask(num, cap)
    x = (torch.randn(cap, c) * mask).to(dtype).requires_grad_()
    gamma = torch.ones(c, requires_grad=True)
    out = ops.masked_batch_norm(x, mask, num, gamma, torch.zeros(c),
                                torch.zeros(c), torch.ones(c), train=True)[0]
    assert type(out.grad_fn).__name__ == "MaskedBatchNormFnBackward"


def test_batch_norm_eval_and_no_grad_keep_the_plain_ops():
    """Eval runs the plain ops; under no_grad training's Function gives
    the plain ops' output and keeps nothing."""
    gen = torch.Generator().manual_seed(3)
    cap, num, c = 64, 50, 16
    mask = ops.valid_mask(num, cap)
    x = torch.randn(cap, c, generator=gen) * mask
    args = (x, mask, num, torch.ones(c), torch.zeros(c), torch.zeros(c),
            torch.ones(c))
    for train in (False, True):
        with torch.no_grad():
            got = ops.masked_batch_norm(*args, train=train)
            ref = ops.masked_batch_norm_plain(*args, train=train)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert got[0].grad_fn is None


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_conv1x1_function_matches_plain_product(dtype):
    gen = torch.Generator().manual_seed(5)
    rows, cin, cout = 300, 96, 384
    x = (torch.randn(rows, cin, generator=gen)).to(dtype)
    x[250:] = 0
    w = torch.randn(cin, cout, generator=gen)
    dy = torch.randn(rows, cout, generator=gen).to(dtype)
    dy[250:] = 0
    res = []
    for f in (ops.conv1x1,
              lambda a, b: ops.matmul_f32(a, b.to(a.dtype)).to(a.dtype)):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = f(xx, ww)
        y.backward(dy)
        res.append((y.detach(), xx.grad, ww.grad))
    (y, dx, dw), (y0, dx0, dw0) = res
    for a, b in ((y, y0), (dx, dx0)):
        assert a.dtype == b.dtype == dtype
        assert torch.allclose(a.float(), b.float(), rtol=1e-6, atol=1e-6)
    assert torch.count_nonzero(dx[250:]) == 0
    # dW is the fp32 sum of the products; autograd of the plain product
    # rounds it to x's dtype on its way to the fp32 weight
    exact = x.float().t() @ dy.float()
    assert dw.dtype == dw0.dtype == torch.float32
    assert torch.allclose(dw, exact, rtol=1e-5, atol=1e-5)
    assert torch.allclose(dw0, exact, rtol=1e-5 if dtype == torch.float32
                          else 2.0 ** -8, atol=1e-5)


def _surface(seed, n=1500, span=48):
    """Voxels of a few planes in a box (a room's walls and floor)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, span, (n, 3))
    pts[: n // 3, 2] = 0
    pts[n // 3: 2 * n // 3, 0] = 0
    return np.unique(pts, axis=0)


def test_bf16_training_forward_keeps_no_fp32_rows():
    """The saved tensors of a bf16 MinkUNet101 training forward (constant
    input, the prehead as the distill step runs it): none is fp32 (or
    wider) with the level-0 cap's rows and more than one column."""
    coords = np.concatenate([
        np.concatenate([np.full((len(s), 1), b), s], 1)
        for b, s in enumerate((_surface(0), _surface(1)))]).astype(np.int32)
    # caps just above each level's count: the default buckets start at
    # 4,096 rows, which at level 4's 1,024 channels would spend the test's
    # time on padding
    caps = tuple(-(-(n + 1) // 64) * 64 for n in level_counts(coords))
    geo = build_unet_geometry(coords, caps=GeometryCaps(cap0=caps[0],
                                                        fixed=caps))
    cap = geo.levels[0].cap
    model = MinkUNet(3, 768, "MinkUNet101").train()
    x = torch.zeros((cap, 3), dtype=torch.bfloat16)
    x[:len(coords)] = 1
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(x, geometry_to_device(geo, "cpu"), constant_input=True,
                    return_prehead=True)
    assert out.dtype == torch.bfloat16 and out.requires_grad
    assert len(saved) > 200
    wide = [(d, s) for d, s in saved
            if d.itemsize >= 4 and d.is_floating_point and len(s) == 2
            and cap in s and min(s) > 1]
    assert wide == []


DTYPES3 = [torch.float32, torch.bfloat16, torch.float64]


def _bn_inputs(dtype, c=24, cap=300, num=257, seed=11):
    gen = torch.Generator().manual_seed(seed)
    mask = ops.valid_mask(num, cap)
    x = ((torch.randn(cap, c, generator=gen, dtype=torch.float64) * 2 + 0.5)
         * mask).to(dtype)
    dy = (torch.randn(cap, c, generator=gen, dtype=torch.float64)
          * mask).to(dtype)
    gamma = torch.randn(c, generator=gen)
    beta = torch.randn(c, generator=gen)
    return x, mask, num, gamma, beta, dy


def _module_bn(x, mask, num, gamma, beta, running_mean, running_var, *,
               train, relu=False):
    """``MaskedBatchNorm`` with ``masked_batch_norm``'s signature."""
    m = MaskedBatchNorm(x.shape[1]).train(train)
    del m.gamma, m.beta   # the caller's tensors, whose gradients it reads
    m.gamma, m.beta = gamma, beta
    m.mean.copy_(running_mean)
    m.var.copy_(running_var)
    return m(x, mask, num, relu=relu), m.mean, m.var


@pytest.mark.parametrize("entry", ["masked_batch_norm", "MaskedBatchNorm"])
@pytest.mark.parametrize("dtype", DTYPES3, ids=["fp32", "bf16", "fp64"])
def test_relu_batch_norm_is_relu_of_its_output_on_the_cpu(dtype, entry):
    """Training on the CPU, through the op and through the model's
    module: ``relu=True`` gives ``relu`` of the output without it bit for
    bit: the output, the running buffers, ``dx``, ``dgamma`` and
    ``dbeta``."""
    x, mask, num, gamma, beta, dy = _bn_inputs(dtype)
    fn = ops.masked_batch_norm if entry == "masked_batch_norm" else _module_bn

    def with_flag(*args, train):
        return fn(*args, train=train, relu=True)

    def after(*args, train):
        out, nm, nv = fn(*args, train=train)
        return torch.relu(out), nm, nv

    got = _bn_run(with_flag, x, mask, num, gamma, beta, dy)
    ref = _bn_run(after, x, mask, num, gamma, beta, dy)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[0].min() >= 0 and torch.count_nonzero(got[3][num:]) == 0
    assert not torch.equal(got[1], torch.full_like(gamma, 0.3))


@pytest.mark.parametrize("entry", ["masked_batch_norm", "MaskedBatchNorm"])
@pytest.mark.parametrize("dtype", DTYPES3, ids=["fp32", "bf16", "fp64"])
def test_eval_relu_batch_norm_is_relu_of_the_eval_output(dtype, entry):
    """Eval, through the op and the module: ``relu=True`` is ``relu`` of
    the plain ops' eval output, and the running buffers stay."""
    x, mask, num, gamma, beta, _ = _bn_inputs(dtype, seed=12)
    rm0, rv0 = torch.randn(24) * 0.1, torch.rand(24) + 0.5
    args = (x, mask, num, gamma, beta, rm0.clone(), rv0.clone())
    fn = ops.masked_batch_norm if entry == "masked_batch_norm" else _module_bn
    out, nm, nv = fn(*args, train=False, relu=True)
    ref = ops.masked_batch_norm_plain(x, mask, num, gamma, beta, rm0, rv0,
                                      train=False)[0]
    assert torch.equal(out, torch.relu(ref))
    assert torch.equal(nm, rm0) and torch.equal(nv, rv0)


def _bn64_autograd(x, num, gamma, beta, dy, relu):
    """The plain ops' autograd in float64: out, batch mean and variance,
    dx, dgamma, dbeta."""
    xx = x.double().requires_grad_()
    g = gamma.double().requires_grad_()
    b = beta.double().requires_grad_()
    mask = ops.valid_mask(num, x.shape[0], dtype=torch.float64)
    n = float(max(num, 1))
    mean = (xx * mask).sum(0) / n
    var = (((xx - mean) * mask) ** 2).sum(0) / n
    out = ((xx - mean) * torch.rsqrt(var + 1e-5) * g + b) * mask
    if relu:
        out = torch.relu(out)
    out.backward(dy.double())
    return (out.detach(), mean.detach(), var.detach() * n / max(n - 1, 1),
            xx.grad, g.grad, b.grad)


@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("num", [1, 5, 257])
def test_kernel_route_plain_versions_match_float64_autograd(relu, num):
    """The card's route on the CPU: ``MaskedBatchNormKernelFn`` through
    the wrappers' plain versions (Welford-free but the same closed forms
    as the kernels) in float64 against the float64 autograd of the plain
    ops; the running buffers moved in place; padded rows of ``out`` and
    ``dx`` exactly zero; no launch counted."""
    x, _, _, gamma, beta, dy = _bn_inputs(torch.float64, num=num, seed=num)
    dy[num:] = 7.0  # read on the valid rows only
    before = (batch_norm.masked_bn_fwd.launches,
              batch_norm.masked_bn_bwd.launches)
    xx = x.clone().requires_grad_()
    g = gamma.double().requires_grad_()
    b = beta.double().requires_grad_()
    rm = torch.full((24,), 0.3, dtype=torch.float64)
    rv = torch.full((24,), 1.7, dtype=torch.float64)
    out = batch_norm.MaskedBatchNormKernelFn.apply(xx, num, g, b, rm, rv,
                                                   relu, 0.1, 1e-5)
    out.backward(dy)
    ref = _bn64_autograd(x, num, gamma, beta, dy, relu)
    want_rm = 0.9 * 0.3 + 0.1 * ref[1]
    want_rv = 0.9 * 1.7 + 0.1 * ref[2]
    for got, want in ((out, ref[0]), (rm, want_rm), (rv, want_rv),
                      (xx.grad, ref[3]), (g.grad, ref[4]), (b.grad, ref[5])):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
    assert torch.count_nonzero(out[num:]) == 0
    assert torch.count_nonzero(xx.grad[num:]) == 0
    assert (batch_norm.masked_bn_fwd.launches,
            batch_norm.masked_bn_bwd.launches) == before


def _plain_route(x, num, gamma, beta, dy, relu, fault):
    """The kernels' route through the wrappers' plain versions, with the
    buffers at ``dev_bn_bench.RUNNING``, optionally with a planted fault:
    ``inv`` 1% high (a finalize that rounds it wrongly) or ``dx`` without
    its ``xhat * dgamma / n`` term."""
    rm = torch.full_like(gamma, dev_bn_bench.RUNNING[0])
    rv = torch.full_like(gamma, dev_bn_bench.RUNNING[1])
    out, stats = batch_norm.masked_bn_fwd_plain(x, num, gamma, beta, rm, rv,
                                                relu=relu)
    if fault == "inv":
        stats = stats * torch.tensor([[1.0], [1.01]])
        y = (x[:num].float() - stats[0]) * stats[1] * gamma + beta
        out = torch.zeros_like(x)
        out[:num] = (torch.relu(y) if relu else y).to(x.dtype)
    dx, dgamma, dbeta = batch_norm.masked_bn_bwd_plain(x, dy, stats, gamma,
                                                       beta, num, relu=relu)
    if fault == "dgamma_term":
        xh = (x[:num].float() - stats[0]) * stats[1]
        dx[:num] = (dx[:num].float() + gamma * stats[1] * xh * dgamma
                    / num).to(x.dtype)
    return out, rm, rv, dx, dgamma, dbeta


@pytest.mark.parametrize("fault", [None, "inv", "dgamma_term"])
@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_kernel_tolerances_pass_the_plain_versions_and_refuse_faults(
        dtype, relu, fault):
    """``dev_bn_bench.tolerance_used``, which holds the kernels to the
    plain ops on the card, run here on the kernels' plain versions: they
    lie within every tolerance, and a planted fault (a wrong ``inv``, a
    dropped ``dgamma`` term in ``dx``) leaves it."""
    x, mask, num, gamma, beta, dy = _bn_inputs(dtype)
    got = _plain_route(x, num, gamma, beta, dy, relu, fault)
    used = dev_bn_bench.tolerance_used(x, mask, num, dy, gamma, beta, relu,
                                       got)
    if fault is None:
        assert max(used.values()) <= 1, used
    else:
        assert used["dx"] > 1, used
        assert (used["out"] > 1) == (fault == "inv"), used


def test_cpu_training_launches_no_batch_norm_kernel():
    """A CPU training step of a MinkUNet takes ``MaskedBatchNormFn``: the
    kernel wrappers' counters stay 0 and every BatchNorm's running
    buffers move."""
    s = _surface(4)
    coords = np.concatenate([np.zeros((len(s), 1)), s], 1).astype(np.int32)
    geo = geometry_to_device(build_unet_geometry(coords), "cpu")
    model = MinkUNet(3, 8, "MinkUNet14A").train()
    x = torch.zeros((geo.levels[0].cap, 3))
    x[:len(coords)] = 1
    counts = (batch_norm.masked_bn_fwd.launches,
              batch_norm.masked_bn_bwd.launches)
    model(x, geo, constant_input=True).sum().backward()
    assert (batch_norm.masked_bn_fwd.launches,
            batch_norm.masked_bn_bwd.launches) == counts
    moved = [m.mean.abs().sum() > 0 for m in model.modules()
             if type(m).__name__ == "MaskedBatchNorm"]
    assert len(moved) > 20 and all(moved)


@pytest.mark.parametrize("c,num,cap,vec", [
    (1, 1, 4096, 1), (32, 1_040_000, 1_115_648, 8), (96, 61_300, 70_000, 8),
    (96, 61_300, 70_000, 4), (384, 1_040_000, 1_115_648, 8),
    (1024, 8_100, 9_728, 8), (1024, 5, 64, 4), (48, 0, 512, 8),
    (7, 3_000_000, 3_100_000, 1), (32, 300, 300, 8)])
def test_tiling_covers_every_channel_and_row(c, num, cap, vec):
    """The kernels' launch shape: channel tiles of at most 32 groups cover
    C; the splits cover the valid rows; the reduce grid fills the card's
    132 SMs four times over where the rows allow a thread ``UNROLL`` of
    them, and gives a thread at least that many where it splits; the
    elementwise grid reaches every row."""
    t = batch_norm.tiling(c, num, cap, vec, 132)
    groups = c // vec
    tiles = -(-groups // t.tx)
    lanes = batch_norm.THREADS // t.tx
    assert t.vec == vec and 1 <= t.tx <= 32 and tiles * t.tx >= groups
    assert tiles * t.tx - groups < tiles   # tiles of nearly equal width
    rows = max(num, 1)
    assert t.splits * t.rps >= rows
    assert 1 <= t.splits <= 65535 and 1 <= t.blocks <= 65535
    if rows >= 4 * 132 * lanes * batch_norm.UNROLL:
        assert tiles * t.splits >= 4 * 132
    if t.splits > 1:
        assert t.rps >= lanes * batch_norm.UNROLL
    assert (t.blocks * lanes * batch_norm.UNROLL >= cap
            or t.blocks == 65535)
