"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode); the module imports no JAX, so it runs on the card
machine:

    python -m pytest tests/test_torch_kernels_cuda.py -q

bf16 kernels are compared with the f32 plain version on the same bf16
inputs; the bound is the bf16 rounding of the intermediates (about 1e-2 of
max |ref| measured on the H100), and 3e-2 fails.
"""

import numpy as np
import pytest
import torch

from vgqa_tpu_torch.models import video_swin as tvs
from vgqa_tpu_torch.ops.kernels.flash_train import (
    flash_mha_train,
    flash_train_bwd,
    flash_train_bwd_reference,
    flash_train_fwd,
    flash_train_fwd_reference,
    fold_heads,
)
from vgqa_tpu_torch.ops.kernels.swin_block import (
    swin_block_canvas,
    swin_block_canvas_reference,
)
from vgqa_tpu_torch.ops.kernels.window_attention import (
    window_attention,
    window_attention_reference,
)

CUDA_REL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _block_weights(rng, C):
    def r(*s, sc=0.2):
        return (rng.randn(*s) * sc).astype(np.float32)

    return [1 + r(C), r(C), r(C, 3 * C, sc=C ** -0.5), r(3 * C),
            r(C, C, sc=C ** -0.5), r(C), 1 + r(C), r(C),
            r(C, 4 * C, sc=C ** -0.5), r(4 * C), r(4 * C, C, sc=(4 * C) ** -0.5), r(C)]


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [124, 418])
def test_window_attention_kernel_cuda(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(16, S, 256, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    kv = (torch.rand(16, S, generator=g, device=cuda) > 0.2).float()
    kv[:, 0] = 1.0
    bias = torch.randn(8, S, S, generator=g, device=cuda).bfloat16()
    region = torch.randint(0, 3, (4, S), generator=g, device=cuda)
    before = window_attention.launches
    for kw in ({"key_valid": kv}, {"bias": bias, "region": region, "key_valid": kv}):
        out = window_attention(q, k, v, num_heads=8, **kw)
        ref = window_attention_reference(
            q.float(), k.float(), v.float(), num_heads=8,
            **{n: (t.float() if n == "bias" else t) for n, t in kw.items()})
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < CUDA_REL
    assert window_attention.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads,shift,padded", [
    ((16, 14, 14, 96), 3, (4, 3, 3), False),
    ((16, 7, 7, 768), 24, (4, 0, 0), False),
    ((16, 53, 53, 192), 6, (4, 3, 3), True),
])
def test_swin_block_canvas_kernel_cuda(cuda, shape, heads, shift, padded):
    D, H, W, C = shape
    window, shift = tvs._adjust_window((D, H, W), (8, 7, 7), shift)
    dims_p = tuple(d + (-d) % w for d, w in zip((D, H, W), window))
    N = window[0] * window[1] * window[2]
    rng = np.random.RandomState(C)
    ws = [torch.from_numpy(w).to(cuda).bfloat16() for w in _block_weights(rng, C)]
    g = torch.Generator(device=cuda).manual_seed(C)
    canvas = torch.randn(2, *dims_p, C, generator=g, device=cuda).bfloat16()
    bias = (0.2 * torch.randn(heads, N, N, generator=g, device=cuda)).bfloat16()
    region = (torch.from_numpy(tvs._region_partition(dims_p, window, shift)).to(cuda)
              if any(shift) else None)
    valid = tvs._valid_partition((D, H, W), dims_p, window, shift)
    assert (valid is not None) == padded
    valid = None if valid is None else torch.from_numpy(valid).to(cuda)
    gates = torch.tensor([[1.0, 1.25], [0.0, 1.0]], device=cuda)
    out = swin_block_canvas(canvas, *ws, bias, heads, window, shift,
                            region=region, valid=valid, gates=gates)
    ref = swin_block_canvas_reference(canvas.float(), *[w.float() for w in ws],
                                      bias.float(), heads, window, shift,
                                      region=region, valid=valid, gates=gates)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) < CUDA_REL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(124, 124), (418, 418), (70, 130)])
def test_flash_train_kernel_cuda(cuda, Lq, Lk, rate):
    """K3 forward (out, lse) and backward (dq, dk, dv) against the plain
    version in f32 on the same bf16 inputs; at rate 0.1 both draw the same
    keep mask, so the comparison is exact up to rounding."""
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk)
    W, H = 16, 8
    q = torch.randn(W, Lq, H * 32, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(W, Lk, H * 32, generator=g, device=cuda).bfloat16() for _ in range(2))
    do = torch.randn(W, Lq, H * 32, generator=g, device=cuda).bfloat16()
    mask = torch.rand(W, Lk, generator=g, device=cuda) > 0.2
    mask[:, 0] = True
    args = (mask, 77, rate, 32 ** -0.5, H)
    fwd0, bwd0 = flash_mha_train.fwd_launches, flash_mha_train.bwd_launches
    out, lse = flash_train_fwd(q, k, v, *args)
    grads = flash_train_bwd(q, k, v, out, do, lse, *args)
    f32 = [fold_heads(t.float(), H) for t in (q, k, v, do)]
    maskf = mask.repeat_interleave(H, dim=0)
    ref_out, ref_lse = flash_train_fwd_reference(*f32[:3], maskf, 77, rate, 32 ** -0.5)
    ref_grads = flash_train_bwd_reference(*f32[:3], ref_out, f32[3], ref_lse, maskf, 77,
                                          rate, 32 ** -0.5)
    torch.cuda.synchronize()
    assert _rel_err(fold_heads(out, H), ref_out) < CUDA_REL
    assert (lse - ref_lse).abs().max().item() < 1e-2
    for got, want in zip(grads, ref_grads):
        assert _rel_err(fold_heads(got, H), want) < CUDA_REL
    assert (flash_mha_train.fwd_launches, flash_mha_train.bwd_launches) == (fwd0 + 1, bwd0 + 1)
