"""Pieces of the train step on the card.  Imports no JAX; skips without
CUDA.

* ``sparse/ops.py:MaskedBatchNormFn`` in bf16 against the plain ops'
  autograd (``masked_batch_norm_plain``): the forward, the running
  statistics, ``dx``, ``dgamma`` and ``dbeta`` bit-equal with the card's
  own reductions; ``dx`` zero at padded rows.
* ``data/batch.py:_target_buffer``: a train batch's fp16 targets are
  zeroed page-locked memory, so the step's upload is one DMA, also when
  loader threads assemble batches at once.

    python -m pytest tests/test_torch_train_cuda.py -q
"""

import pytest
import torch

from openscene_tpu_torch.data import batch
from openscene_tpu_torch.sparse import ops


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


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
    got = _bn_run(ops.masked_batch_norm, x, mask, num, gamma, beta, dy)
    ref = _bn_run(ops.masked_batch_norm_plain, x, mask, num, gamma, beta, dy)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.count_nonzero(got[3][num:]) == 0


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
