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
"""

import numpy as np
import pytest
import torch

from openscene_tpu_torch.models.sparse_unet import MinkUNet
from openscene_tpu_torch.sparse import ops
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
