"""The serialized patch attention's CUDA kernels (``csrc/patch_attn.cu``,
``sparse/patch_attn.py``) against their plain version on the card, forward
and backward, on ragged ``cu_seqlens`` (full, short and one-row patches,
an empty patch, rows outside every patch) at 2, 4 and 16 heads; two runs
bit-equal; launch counts; what they refuse.  Imports no JAX; skips without
CUDA.

    python -m pytest tests/test_torch_ptv3_cuda.py -q --noconftest
"""

import pytest
import torch

from openscene_tpu_torch.sparse import patch_attn


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def _layout(lengths, dev, tail=5, lead=0):
    starts = [lead]
    for n in lengths:
        starts.append(starts[-1] + n)
    return (torch.tensor(starts, dtype=torch.int32, device=dev),
            starts[-1] + tail)


def _dirty_outputs(monkeypatch):
    """The wrappers' uncleared outputs start as NaN: the kernels must
    write every row, the rows outside every patch as zeros."""
    empty, empty_like = torch.empty, torch.empty_like

    def nan(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t
    monkeypatch.setattr(torch, "empty", lambda *a, **k: nan(empty(*a, **k)))
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **k: nan(empty_like(*a, **k)))


def _close(got, want, tol):
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    assert err <= tol * max(scale, 1e-6), (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 4, 16])
def test_kernels_match_plain(heads, monkeypatch):
    dev = _card()
    torch.manual_seed(heads)
    lead = heads % 3  # rows before the first patch
    cu, rows = _layout([1024, 700, 1024, 37, 1, 0, 1024, 130], dev,
                       lead=lead)
    qkv = (torch.randn(rows, 3 * 16 * heads, device=dev) * 2).to(
        torch.bfloat16)
    dout = torch.randn(rows, 16 * heads, device=dev).to(torch.bfloat16)
    inside = torch.zeros(rows, dtype=torch.bool, device=dev)
    inside[lead:int(cu[-1])] = True
    dout = dout * inside[:, None]
    scale = 16 ** -0.5
    _dirty_outputs(monkeypatch)
    f0, b0 = patch_attn.patch_attn_fwd.launches, \
        patch_attn.patch_attn_bwd.launches
    out, lse = patch_attn.patch_attn_fwd(qkv, cu, heads, scale, 1024)
    dqkv = patch_attn.patch_attn_bwd(qkv, out, lse, dout, cu, heads, scale,
                                     1024)
    assert patch_attn.patch_attn_fwd.launches - f0 == 1
    assert patch_attn.patch_attn_bwd.launches - b0 == 2
    out2, lse2 = patch_attn.patch_attn_fwd(qkv, cu, heads, scale, 1024)
    dqkv2 = patch_attn.patch_attn_bwd(qkv, out, lse, dout, cu, heads,
                                      scale, 1024)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(dqkv, dqkv2)
    # the oracle on the same bf16 operands, in fp32
    ref_out, ref_lse = patch_attn.patch_attn_fwd_plain(qkv, cu, heads, scale)
    ref_d = patch_attn.patch_attn_bwd_plain(qkv, ref_out, ref_lse, dout, cu,
                                            heads, scale)
    _close(out, ref_out, 2e-2)
    _close(lse, ref_lse, 1e-5)
    c = 16 * heads
    for part in range(3):
        _close(dqkv[:, part * c:(part + 1) * c],
               ref_d[:, part * c:(part + 1) * c], 3e-2)
    # rows outside every patch are zero
    assert not out[~inside].any() and not lse[~inside].any()
    assert not dqkv[~inside].any()


@pytest.mark.cuda
def test_kernels_refuse():
    dev = _card()
    cu, rows = _layout([64], dev)
    qkv = torch.zeros(rows, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        patch_attn.patch_attn_fwd(qkv.float(), cu, 2, 0.25, 64)
    with pytest.raises(ValueError):
        patch_attn.patch_attn_fwd(qkv, cu, 3, 0.25, 64)
    with pytest.raises(TypeError):
        patch_attn.patch_attn_fwd(qkv, cu.long(), 2, 0.25, 64)
