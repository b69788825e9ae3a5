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
from vgqa_tpu_torch.ops.kernels.flash_attention import (
    flash_gqa_causal,
    flash_gqa_causal_reference,
    flash_mha,
    flash_mha_reference,
)
from vgqa_tpu_torch.ops.kernels.flash_train import (
    flash_mha_train,
    flash_train_bwd,
    flash_train_bwd_reference,
    flash_train_fwd,
    flash_train_fwd_reference,
    fold_heads,
    keep_mask,
    pack_keep_bits,
)
from vgqa_tpu_torch.ops.kernels.int4_matmul import (
    int4_matmul,
    int4_matmul_kernel_applicable,
    int4_matmul_reference,
)
from vgqa_tpu_torch.ops.kernels.swin_block import (
    swin_block_canvas,
    swin_block_canvas_reference,
    swin_block_fused,
    swin_block_fused_reference,
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
@pytest.mark.parametrize("shape,heads,shift,padded", [
    ((16, 14, 14, 96), 3, (4, 3, 3), False),
    ((16, 7, 7, 768), 24, (4, 0, 0), False),
    ((16, 53, 53, 192), 6, (4, 3, 3), True),
])
def test_swin_block_fused_kernel_cuda(cuda, shape, heads, shift, padded):
    """K1' on the windows of the rolled canvas against its plain version,
    and against K1 on the canvas (the same chain with identity row maps)."""
    D, H, W, C = shape
    window, shift = tvs._adjust_window((D, H, W), (8, 7, 7), shift)
    dims_p = tuple(d + (-d) % w for d, w in zip((D, H, W), window))
    N = window[0] * window[1] * window[2]
    rng = np.random.RandomState(C + 1)
    ws = [torch.from_numpy(w).to(cuda).bfloat16() for w in _block_weights(rng, C)]
    g = torch.Generator(device=cuda).manual_seed(C + 1)
    canvas = torch.randn(2, *dims_p, C, generator=g, device=cuda).bfloat16()
    bias = (0.2 * torch.randn(heads, N, N, generator=g, device=cuda)).bfloat16()
    region = (torch.from_numpy(tvs._region_partition(dims_p, window, shift)).to(cuda)
              if any(shift) else None)
    valid = tvs._valid_partition((D, H, W), dims_p, window, shift)
    assert (valid is not None) == padded
    valid = None if valid is None else torch.from_numpy(valid).to(cuda)
    rolled = torch.roll(canvas, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    windows = tvs.window_partition(rolled, window)
    before = swin_block_fused.launches
    out = swin_block_fused(windows, *ws, bias, heads, region=region, valid=valid)
    ref = swin_block_fused_reference(windows.float(), *[w.float() for w in ws], bias.float(),
                                     heads, region=region, valid=valid)
    k1 = swin_block_canvas(canvas, *ws, bias, heads, window, shift, region=region, valid=valid)
    torch.cuda.synchronize()
    assert swin_block_fused.launches == before + 1
    assert _rel_err(out, ref) < CUDA_REL
    assert _rel_err(tvs.window_reverse(out, window, 2, *dims_p), k1) < CUDA_REL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(124, 124), (418, 418), (70, 130), (1024, 1024)])
def test_flash_train_kernel_cuda(cuda, Lq, Lk, rate):
    """K3 forward (out, lse) and backward (dq, dk, dv) against the plain
    version in f32 on the same bf16 inputs; at rate 0.1 both draw the same
    keep mask, so the comparison is exact up to rounding, and the forward's
    keep bits equal the plain mask packed. A second backward is bit-equal
    to the first (no atomics, a fixed summation order)."""
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk)
    W, H = 16, 8
    q = torch.randn(W, Lq, H * 32, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(W, Lk, H * 32, generator=g, device=cuda).bfloat16() for _ in range(2))
    do = torch.randn(W, Lq, H * 32, generator=g, device=cuda).bfloat16()
    mask = torch.rand(W, Lk, generator=g, device=cuda) > 0.2
    mask[:, 0] = True
    args = (mask, 77, rate, 32 ** -0.5, H)
    fwd0, bwd0 = flash_mha_train.fwd_launches, flash_mha_train.bwd_launches
    out, lse, bits = flash_train_fwd(q, k, v, *args)
    grads = flash_train_bwd(q, k, v, out, do, lse, bits, mask, rate, 32 ** -0.5, H)
    again = flash_train_bwd(q, k, v, out, do, lse, bits, mask, rate, 32 ** -0.5, H)
    f32 = [fold_heads(t.float(), H) for t in (q, k, v, do)]
    maskf = mask.repeat_interleave(H, dim=0)
    ref_out, ref_lse = flash_train_fwd_reference(*f32[:3], maskf, 77, rate, 32 ** -0.5)
    ref_grads = flash_train_bwd_reference(*f32[:3], ref_out, f32[3], ref_lse, maskf, 77,
                                          rate, 32 ** -0.5)
    torch.cuda.synchronize()
    assert _rel_err(fold_heads(out, H), ref_out) < CUDA_REL
    assert (lse - ref_lse).abs().max().item() < 1e-2
    for got, want, second in zip(grads, ref_grads, again):
        assert _rel_err(fold_heads(got, H), want) < CUDA_REL
        assert torch.equal(got, second)
    if rate > 0:
        assert torch.equal(bits, pack_keep_bits(keep_mask(77, W * H, Lq, Lk, rate, cuda)))
    else:
        assert bits is None
    assert (flash_mha_train.fwd_launches, flash_mha_train.bwd_launches) == (fwd0 + 1, bwd0 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_flash_mha_kernel_cuda(cuda, masked):
    """K4 at the InternViT shape (2 tiles x 16 heads, L = 1025, dh = 64) on
    q/k/v sliced from one fused qkv tensor, as the ViT passes them; with a
    key mask that leaves one row of keys fully masked."""
    g = torch.Generator(device=cuda).manual_seed(int(masked))
    T, L, H = 2, 1025, 16
    qkv = torch.randn(T, L, 3 * H * 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.split(H * 64, dim=-1)
    mask = None
    if masked:
        mask = torch.rand(T, L, generator=g, device=cuda) > 0.3
        mask[1] = False
    before = flash_mha.launches
    out = flash_mha(q, k, v, H, key_mask=mask)
    ref = flash_mha_reference(q.float(), k.float(), v.float(), H, key_mask=mask)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    assert _rel_err(out, ref) < CUDA_REL
    if masked:     # a fully masked row averages V over its keys
        mean = v[1].float().mean(0)
        assert (out[1].float() - mean).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset,length", [(0, 8700), (8192, 8700), (0, 600)])
def test_flash_gqa_causal_kernel_cuda(cuda, q_offset, length):
    """K5 at the prefill shape (H 32, Hkv 8, dh 128, Lq 1024, S 9216) with
    q as the [L, H, dh] -> [H, L, dh] view the LLM passes."""
    g = torch.Generator(device=cuda).manual_seed(q_offset + length)
    H, Hkv, Lq, S, dh = 32, 8, 1024, 9216, 128
    q = torch.randn(Lq, H, dh, generator=g, device=cuda).bfloat16().transpose(0, 1)
    k, v = (torch.randn(Hkv, S, dh, generator=g, device=cuda).bfloat16() for _ in range(2))
    n = torch.tensor(length, device=cuda)
    before = flash_gqa_causal.launches
    out = flash_gqa_causal(q, k, v, q_offset, n)
    ref = flash_gqa_causal_reference(q.float(), k.float(), v.float(), q_offset, n)
    torch.cuda.synchronize()
    assert flash_gqa_causal.launches == before + 1
    assert _rel_err(out, ref) < CUDA_REL


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 5, 16, 64])
@pytest.mark.parametrize("K,N,g", [(4096, 4096, 128), (4096, 1024, 128), (14336, 4096, 128),
                                   (4096, 14336, 128), (1024, 90, 128), (1024, 512, 8),
                                   (1024, 512, 1), (96, 64, 24), (96, 64, 3)])
def test_int4_matmul_kernel_cuda(cuda, M, K, N, g):
    """K6 at the production shapes, M up to the gate's 64 and every kind of
    group size the gate admits (a multiple of 16, a power of 2 below 16, an
    odd divisor of a small K/2), against the plain per-group version on the
    same bf16 activations; a second call gives the same bits (the split-K
    sum does not depend on the order in which the blocks ran)."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N + g)
    n_g = K // g
    assert int4_matmul_kernel_applicable(M, K, N, n_g)
    packed = torch.randint(-128, 128, (K // 2, N), generator=gen, device=cuda,
                           dtype=torch.int32).to(torch.int8)
    scale = torch.rand(n_g, N, generator=gen, device=cuda) * 0.01
    x = torch.randn(M, K, generator=gen, device=cuda).bfloat16()
    before = int4_matmul.launches
    out = int4_matmul(x, packed, scale)
    again = int4_matmul(x, packed, scale)
    ref = int4_matmul_reference(x, packed, scale)
    torch.cuda.synchronize()
    assert int4_matmul.launches == before + 2
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.equal(out, again)
    assert _rel_err(out, ref.float()) < CUDA_REL


# ---- the float32 forms of K1 / K1' / K2 / K3 ---------------------------------
# f32 kernels (FFMA, nothing rounded) against the f32 plain version on the
# same inputs: only the summation order differs, so 1e-4 of max |ref| fails.
F32_REL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("S", [124, 392, 418])
def test_window_attention_kernel_f32_cuda(cuda, S):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(16, S, 256, generator=g, device=cuda) for _ in range(3))
    kv = (torch.rand(16, S, generator=g, device=cuda) > 0.2).float()
    kv[:, 0] = 1.0
    bias = torch.randn(8, S, S, generator=g, device=cuda)
    region = torch.randint(0, 3, (4, S), generator=g, device=cuda)
    before = window_attention.launches
    for kw in ({"key_valid": kv}, {"bias": bias, "region": region, "key_valid": kv}):
        out = window_attention(q, k, v, num_heads=8, **kw)
        ref = window_attention_reference(q, k, v, num_heads=8, **kw)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32
        assert _rel_err(out, ref) < F32_REL
    assert window_attention.launches == before + 2


def _swin_f32_case(cuda, shape, heads, shift, padded, seed):
    D, H, W, C = shape
    window, shift = tvs._adjust_window((D, H, W), (8, 7, 7), shift)
    dims_p = tuple(d + (-d) % w for d, w in zip((D, H, W), window))
    N = window[0] * window[1] * window[2]
    rng = np.random.RandomState(seed)
    ws = [torch.from_numpy(w).to(cuda) for w in _block_weights(rng, C)]
    g = torch.Generator(device=cuda).manual_seed(seed)
    canvas = torch.randn(2, *dims_p, C, generator=g, device=cuda)
    bias = 0.2 * torch.randn(heads, N, N, generator=g, device=cuda)
    region = (torch.from_numpy(tvs._region_partition(dims_p, window, shift)).to(cuda)
              if any(shift) else None)
    valid = tvs._valid_partition((D, H, W), dims_p, window, shift)
    assert (valid is not None) == padded
    valid = None if valid is None else torch.from_numpy(valid).to(cuda)
    return window, shift, dims_p, ws, canvas, bias, region, valid


SWIN_F32_CASES = [
    ((16, 14, 14, 96), 3, (4, 3, 3), False),
    ((16, 7, 7, 768), 24, (4, 0, 0), False),
    ((16, 53, 53, 192), 6, (4, 3, 3), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads,shift,padded", SWIN_F32_CASES)
def test_swin_block_canvas_kernel_f32_cuda(cuda, shape, heads, shift, padded):
    torch.backends.cuda.matmul.allow_tf32 = False
    window, shift, _, ws, canvas, bias, region, valid = _swin_f32_case(
        cuda, shape, heads, shift, padded, shape[-1] + 2)
    gates = torch.tensor([[1.0, 1.25], [0.0, 1.0]], device=cuda)
    before = swin_block_canvas.launches
    out = swin_block_canvas(canvas, *ws, bias, heads, window, shift,
                            region=region, valid=valid, gates=gates)
    ref = swin_block_canvas_reference(canvas, *ws, bias, heads, window, shift,
                                      region=region, valid=valid, gates=gates)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and swin_block_canvas.launches == before + 1
    assert _rel_err(out, ref) < F32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads,shift,padded", SWIN_F32_CASES)
def test_swin_block_fused_kernel_f32_cuda(cuda, shape, heads, shift, padded):
    torch.backends.cuda.matmul.allow_tf32 = False
    window, shift, dims_p, ws, canvas, bias, region, valid = _swin_f32_case(
        cuda, shape, heads, shift, padded, shape[-1] + 3)
    rolled = torch.roll(canvas, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    windows = tvs.window_partition(rolled, window)
    before = swin_block_fused.launches
    out = swin_block_fused(windows, *ws, bias, heads, region=region, valid=valid)
    ref = swin_block_fused_reference(windows, *ws, bias, heads, region=region, valid=valid)
    k1 = swin_block_canvas(canvas, *ws, bias, heads, window, shift, region=region, valid=valid)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and swin_block_fused.launches == before + 1
    assert _rel_err(out, ref) < F32_REL
    assert _rel_err(tvs.window_reverse(out, window, 2, *dims_p), k1) < F32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(124, 124), (418, 418), (70, 130), (1024, 1024)])
def test_flash_train_kernel_f32_cuda(cuda, Lq, Lk, rate):
    """K3's float32 forward (out, lse) and backward (dq, dk, dv) against the
    f32 plain version; at rate 0.1 the forward's keep bits are bit-equal to
    the bf16 kernel's on the same seed and shape, and to the plain mask
    packed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(Lq + 3 * Lk)
    W, H = 16, 8
    q, do = (torch.randn(W, Lq, H * 32, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(W, Lk, H * 32, generator=g, device=cuda) for _ in range(2))
    mask = torch.rand(W, Lk, generator=g, device=cuda) > 0.2
    mask[:, 0] = True
    mask[1] = False                       # one row of keys fully masked
    args = (mask, 91, rate, 32 ** -0.5, H)
    fwd0, bwd0 = flash_mha_train.fwd_launches, flash_mha_train.bwd_launches
    out, lse, bits = flash_train_fwd(q, k, v, *args)
    grads = flash_train_bwd(q, k, v, out, do, lse, bits, mask, rate, 32 ** -0.5, H)
    f32 = [fold_heads(t, H) for t in (q, k, v, do)]
    maskf = mask.repeat_interleave(H, dim=0)
    ref_out, ref_lse = flash_train_fwd_reference(*f32[:3], maskf, 91, rate, 32 ** -0.5)
    ref_grads = flash_train_bwd_reference(*f32[:3], ref_out, f32[3], ref_lse, maskf, 91,
                                          rate, 32 ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and all(t.dtype == torch.float32 for t in grads)
    assert _rel_err(fold_heads(out, H), ref_out) < F32_REL
    live = ref_lse > -1e29                # rows with an attended key
    assert (lse - ref_lse)[live].abs().max().item() < 1e-4
    assert torch.equal(lse[~live], ref_lse[~live])      # -1e30 for the masked row
    for got, want in zip(grads, ref_grads):
        assert _rel_err(fold_heads(got, H), want) < F32_REL
    if rate > 0:
        bf_bits = flash_train_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), *args)[2]
        assert torch.equal(bits, bf_bits)
        assert torch.equal(bits, pack_keep_bits(keep_mask(91, W * H, Lq, Lk, rate, cuda)))
        fwd0 += 1                         # the bf16 forward above
    else:
        assert bits is None
    assert (flash_mha_train.fwd_launches, flash_mha_train.bwd_launches) == (fwd0 + 1, bwd0 + 1)


# ---- K4 on its Hopper kernel (wgmma, TMA) at ragged and full shapes -----------
@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["none", "mask", "full_row"])
@pytest.mark.parametrize("B,H", [(1, 1), (8, 16)])
@pytest.mark.parametrize("L", [1, 64, 65, 128, 129, 144, 145, 1025])
def test_flash_mha_sm90_shapes_cuda(cuda, L, B, H, mask_kind):
    """K4 against its plain version on q/k/v sliced from one fused qkv
    tensor (row stride 3 x H x 64), maskless, with a key mask, and with one
    batch row's keys all masked (that row averages V over its keys); one
    launch per call."""
    g = torch.Generator(device=cuda).manual_seed(L + 7 * B)
    qkv = torch.randn(B, L, 3 * H * 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.split(H * 64, dim=-1)
    mask = None
    if mask_kind != "none":
        mask = torch.rand(B, L, generator=g, device=cuda) > 0.3
        mask[:, 0] = True
        if mask_kind == "full_row":
            mask[B - 1] = False
    before = flash_mha.launches
    out = flash_mha(q, k, v, H, key_mask=mask)
    ref = flash_mha_reference(q.float(), k.float(), v.float(), H, key_mask=mask)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    assert out.shape == (B, L, H * 64) and out.dtype == torch.bfloat16
    assert _rel_err(out, ref) < CUDA_REL
    if mask_kind == "full_row":
        mean = v[B - 1].float().mean(0)
        assert (out[B - 1].float() - mean).abs().max().item() < 2e-2


# ---- K2 and K5 on their Hopper kernels at the ragged shapes they must handle ----
# (the same cases as tests/test_torch_attention_shapes.py, which holds the
# plain versions against the Pallas kernels on the CPU)
K2_RAGGED_N = [1, 16, 17, 124, 128, 129, 130, 418]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("N", K2_RAGGED_N)
def test_window_attention_sm90_shapes_cuda(cuda, N, masked):
    """K2's encoder form (key_valid or no mask: window_attn_sm90_kernel) at
    8 rows x 8 heads of 32: with key_valid of 2 rows repeated over the 8
    (row w reads w % 2) and row 1's keys all masked, whose windows average V
    over their N keys; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(N + 1000 * masked)
    W, H = 8, 8
    qkv = torch.randn(W, N, 3 * H * 32, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.split(H * 32, dim=-1)
    kv = None
    if masked:
        kv = (torch.rand(2, N, generator=g, device=cuda) > 0.3).float()
        kv[0, 0] = 1.0
        kv[1] = 0.0
    before = window_attention.launches
    out = window_attention(q, k, v, key_valid=kv, num_heads=H)
    ref = window_attention_reference(q.float(), k.float(), v.float(), key_valid=kv,
                                     num_heads=H)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert out.shape == (W, N, H * 32) and out.dtype == torch.bfloat16
    assert _rel_err(out, ref) < CUDA_REL
    if masked:
        mean = v[1::2].float().mean(1, keepdim=True).expand(-1, N, -1)
        assert (out[1::2].float() - mean).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("group", [4, 1])
@pytest.mark.parametrize("length", [600, 8700, 9216])
@pytest.mark.parametrize("q_offset", [0, 40, 1000, 8192])
def test_flash_gqa_sm90_prefill_cuda(cuda, q_offset, length, group):
    """K5 at the prefill widths (Hkv 8, dh 128, Lq 1024, S 9216; H 32 at
    group 4, 8 at group 1) with q as the [L, H, dh] -> [H, L, dh] view the
    LLM passes, at chunk offsets on and off the tile grid and lengths inside
    the chunk, past it and at S."""
    g = torch.Generator(device=cuda).manual_seed(q_offset + length + group)
    Hkv, Lq, S, dh = 8, 1024, 9216, 128
    H = Hkv * group
    q = torch.randn(Lq, H, dh, generator=g, device=cuda).bfloat16().transpose(0, 1)
    k, v = (torch.randn(Hkv, S, dh, generator=g, device=cuda).bfloat16() for _ in range(2))
    n = torch.tensor(length, device=cuda)
    before = flash_gqa_causal.launches
    out = flash_gqa_causal(q, k, v, q_offset, n)
    ref = flash_gqa_causal_reference(q.float(), k.float(), v.float(), q_offset, n)
    torch.cuda.synchronize()
    assert flash_gqa_causal.launches == before + 1
    assert out.shape == (H, Lq, dh) and out.dtype == torch.bfloat16
    assert _rel_err(out, ref) < CUDA_REL


# (H, Hkv, Lq, S, q_offset, length): offsets off the 64 / 128 grid, length
# below the chunk's end and on a tile boundary, Lq off the tile, groups 4 and 1
K5_RAGGED = [
    (4, 1, 70, 300, 40, 300),
    (4, 4, 70, 300, 40, 100),
    (8, 2, 130, 400, 200, 256),
    (2, 2, 130, 400, 200, 384),
    (4, 1, 130, 300, 0, 128),
    (4, 4, 70, 300, 128, 300),
    (8, 2, 70, 260, 190, 260),
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,Lq,S,q_offset,length", K5_RAGGED)
def test_flash_gqa_sm90_ragged_cuda(cuda, H, Hkv, Lq, S, q_offset, length):
    """K5 at the ragged cases, q contiguous [H, Lq, 128] and as the
    transposed view of [Lq, H, 128]."""
    g = torch.Generator(device=cuda).manual_seed(H + Lq + q_offset + length)
    q = torch.randn(Lq, H, 128, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(Hkv, S, 128, generator=g, device=cuda).bfloat16() for _ in range(2))
    n = torch.tensor(length, device=cuda)
    for qv in (q.transpose(0, 1), q.transpose(0, 1).contiguous()):
        out = flash_gqa_causal(qv, k, v, q_offset, n)
        ref = flash_gqa_causal_reference(qv.float(), k.float(), v.float(), q_offset, n)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) < CUDA_REL


# ---- K1's Hopper kernels: the wgmma + TMA GEMM (bf16 and 3xTF32) and K2's
# terms form (rel-pos bias, region ids) ----------------------------------------
from vgqa_tpu_torch.ops.kernels import build, swin_block as sb  # noqa: E402

# the GEMM against a torch product with its rounding points: bf16 differs
# from it by a bf16 rounding flipped by the summation order (one ulp, 2^-8
# relative); 3xTF32 differs from the float64 product by about 2^-21 per
# term plus the tensor cores' f32 accumulation over K / 8 x 3 products,
# which grows with K (1.8e-5 of max |ref| at K = 3,072 on an H100). A
# single tf32 product is held to be at least 10x further off.
GEMM_BF16_REL = 8e-3
GEMM_F32_REL = 5e-5


def _gemm_reference(a, w_nk, bias, mode, res=None, rowmap=None, gates=None, gate_col=0,
                    rows_per_sample=1, out=None):
    """The epilogue modes of csrc/gemm_sm90.cu with the kernel's rounding
    points, on an f32 product (float64 for float32 operands)."""
    f32 = a.dtype == torch.float32
    dt = a.dtype

    def rnd(x):
        return x if f32 else x.to(dt).float()

    acc = (a.double() @ w_nk.double().t()).float() if f32 else a.float() @ w_nk.float().t()
    b = bias.float()
    if mode == sb._EPI_BIAS:
        return (rnd(acc) + b).to(dt)
    if mode == sb._EPI_GELU:
        return torch.nn.functional.gelu(acc + b, approximate="none").to(dt)
    t = rnd(rnd(acc) + b)
    M = a.shape[0]
    if gates is not None:
        g = rnd(gates[torch.arange(M, device=a.device) // rows_per_sample, gate_col])
        t = rnd(t * g[:, None])
    idx = torch.arange(M, device=a.device) if rowmap is None else rowmap.long()
    if mode == sb._EPI_RES_GATHER:
        return (res[idx].float() + t).to(dt)
    out = out.clone()
    out[idx] = (res.float() + t).to(dt)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode,maps,gated", [
    (0, False, False), (1, False, False),
    (2, False, False), (2, True, False), (2, True, True),
    (3, False, False), (3, True, False), (3, True, True),
])
@pytest.mark.parametrize("C,layer", [(96, "qkv"), (96, "fc2"), (192, "fc2"), (768, "fc2"),
                                     (32, "fc1")])
def test_gemm_sm90_cuda(cuda, C, layer, mode, maps, gated, dtype):
    """csrc/gemm_sm90.cu alone in each epilogue mode, with and without row
    maps and DropPath gates, bf16 and 3xTF32, at K1's layer shapes (resident
    and streamed W, a clipped last M tile), against a torch product with the
    same rounding points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    N, K = {"qkv": (3 * C, C), "proj": (C, C), "fc1": (4 * C, C), "fc2": (C, 4 * C)}[layer]
    if mode >= 2:          # the residual modes write C-wide rows (proj, fc2)
        N = C
    M = 3 * 128 + 77
    g = torch.Generator(device=cuda).manual_seed(C + mode)
    a = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * K ** -0.5).to(dtype)
    bias = (0.1 * torch.randn(N, generator=g, device=cuda)).to(dtype)
    res = torch.randn(M, N, generator=g, device=cuda).to(dtype) if mode >= 2 else None
    rowmap = torch.randperm(M, generator=g, device=cuda).int() if maps else None
    gates = torch.tensor([[1.1111, 0.0], [0.0, 1.25]], device=cuda) if gated else None
    out = torch.full((M, N), 7.0, device=cuda, dtype=dtype)
    kw = dict(res=res, rowmap=rowmap, gates=gates, gate_col=1 if mode == 3 else 0,
              rows_per_sample=-(-M // 2))
    before = out.clone()
    lib = build.load_library()
    ops = sb._weight_operands(w, cuda, dtype)
    sb._gemm(lib, build.stream_handle(cuda), a, ops, bias, out, N, mode,
             ldr=N if mode >= 2 else 0, **kw)
    ref = _gemm_reference(a, w.t().contiguous(), bias, mode, out=before, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = _rel_err(out, ref)
    assert err < (GEMM_F32_REL if dtype == torch.float32 else GEMM_BF16_REL)
    if dtype == torch.float32 and mode == 0:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one = torch.matmul(a, w) + bias
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert err * 10 < _rel_err(one, ref)


@pytest.mark.cuda
def test_gemm_plan_space_matches_library_cuda(cuda):
    """The host's plan space (swin_block.GEMM_BNS, GEMM_WN, GEMM_SMEM_MAX*,
    gemm_smem_bytes) against csrc/gemm_sm90.cu's own tile table and
    shared-memory formula: the formula over a grid of plans, and every plan
    gemm_plan returns at the CPU plan tests' shapes names a compiled tile
    and the library's byte count."""
    import ctypes

    from test_torch_k1_plan import LAYERS, _cases

    lib = build.load_library()
    buf = (ctypes.c_int * 96)()
    n = lib.vgqa_gemm_sm90_tiles(ctypes.cast(buf, ctypes.c_void_p), 32)
    assert 0 < n <= 32
    tiles = {tuple(buf[3 * i:3 * i + 3]) for i in range(n)}
    assert {(bn, wn) for bn, wn, bps in tiles if bps == 1} == {
        (bn, sb.GEMM_WN[bn]) for bn in sb.GEMM_BNS}
    assert lib.vgqa_gemm_sm90_smem_max(1) == sb.GEMM_SMEM_MAX
    assert lib.vgqa_gemm_sm90_smem_max(2) == sb.GEMM_SMEM_MAX2
    for f32 in (False, True):
        for bn in sb.GEMM_BNS:
            for stages, kps, resident, ksteps in np.ndindex(7, 4, 2, 4):
                args = (f32, bn, stages + 2, kps + 1, bool(resident), 3 * 4 ** int(ksteps))
                assert lib.vgqa_gemm_sm90_smem_bytes(*map(int, args)) == \
                    sb.gemm_smem_bytes(*args)
        for C, layer, M in _cases():
            n_mul, k_mul = LAYERS[layer]
            p = sb.gemm_plan(M, n_mul * C, k_mul * C, f32)
            assert (p["bn"], p["wn"], p["bps"]) in tiles
            assert lib.vgqa_gemm_sm90_smem_bytes(int(f32), p["bn"], p["stages"], p["kps"],
                                                 int(p["resident"]), p["ksteps"]) == p["smem"]
            assert p["smem"] <= lib.vgqa_gemm_sm90_smem_max(p["bps"])


@pytest.mark.cuda
def test_weight_operands_follow_in_place_updates(cuda):
    """The cached weight operands are keyed on the weight's storage and
    version: an in-place update is read, never the stale copy."""
    w = torch.randn(96, 288, device=cuda)
    hi, lo = sb._weight_operands(w, cuda, torch.float32)
    assert torch.equal(hi + lo, w.t())
    assert sb._weight_operands(w, cuda, torch.float32)[0] is hi
    w.mul_(2.0)
    hi2, lo2 = sb._weight_operands(w, cuda, torch.float32)
    assert torch.equal(hi2 + lo2, w.t())


K2_TERMS_N = [392, 98, 130, 49]


@pytest.mark.cuda
@pytest.mark.parametrize("terms", ["bias", "region", "both"])
@pytest.mark.parametrize("N", K2_TERMS_N)
def test_window_attention_sm90_terms_cuda(cuda, N, terms):
    """K2's terms form (window_attn_sm90_kernel with the rel-pos bias and/or
    the SW-MSA region ids: K1's attention phase) at N = 392 (K1's windows),
    and 98, 130 and 49, whose bias rows the wrapper pads to a multiple of 8
    keys for the kernel's TMA boxes; 16 windows x 3 heads, region ids of 4
    rows repeated, against the plain version; one launch."""
    g = torch.Generator(device=cuda).manual_seed(N)
    W, H = 16, 3
    qkv = torch.randn(W, N, 3 * H * 32, generator=g, device=cuda).bfloat16()
    q, k, v = qkv.split(H * 32, dim=-1)
    bias = (0.5 * torch.randn(H, N, N, generator=g, device=cuda)).bfloat16()
    region = torch.randint(0, 4, (4, N), generator=g, device=cuda)
    kw = {"bias": bias if terms != "region" else None,
          "region": region if terms != "bias" else None}
    before = window_attention.launches
    out = window_attention(q, k, v, num_heads=H, scale=32 ** -0.5, **kw)
    ref = window_attention_reference(
        q.float(), k.float(), v.float(), num_heads=H, scale=32 ** -0.5,
        **{n: (None if t is None else t.float() if n == "bias" else t) for n, t in kw.items()})
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert _rel_err(out, ref) < CUDA_REL


# the 9 K1 serving block shapes (64 frames, V = 2 at 224 px, and the padded
# 420 px stage 1)
K1_SERVE_SHAPES = [
    ((64, 56, 56, 96), 3, (0, 0, 0)), ((64, 56, 56, 96), 3, (4, 3, 3)),
    ((64, 28, 28, 192), 6, (0, 0, 0)), ((64, 28, 28, 192), 6, (4, 3, 3)),
    ((64, 14, 14, 384), 12, (0, 0, 0)), ((64, 14, 14, 384), 12, (4, 3, 3)),
    ((64, 7, 7, 768), 24, (0, 0, 0)), ((64, 7, 7, 768), 24, (4, 3, 3)),
    ((64, 53, 53, 192), 6, (4, 3, 3)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,heads,shift", K1_SERVE_SHAPES)
def test_swin_block_serving_shapes_cuda(cuda, shape, heads, shift, dtype):
    """K1 at every serving shape (V = 2; gates with a dropped branch) against
    its plain version (bf16 within 3e-2, float32 within 1e-4 of max |ref|),
    and K1' on the windows of the rolled canvas equal to K1 (max abs diff
    0: the same chain with identity row maps)."""
    _check_k1_and_k1f(cuda, shape, heads, shift, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,heads", [(128, 4), (256, 8), (512, 16), (1024, 32)])
def test_swin_block_swin_b_widths_cuda(cuda, C, heads, dtype):
    """K1 and K1' at Video Swin-B's four widths (the LayerNorm's 4, 8, 16
    and 32 elements per lane, GEMM plans of widths Swin-T lacks) on a
    shifted 16 x 14 x 14 canvas, as at the serving shapes."""
    _check_k1_and_k1f(cuda, (16, 14, 14, C), heads, (4, 3, 3), dtype)


@pytest.mark.cuda
def test_swin_block_rejects_layernorm_width_cuda(cuda):
    """A width the LayerNorm is not compiled for (C = 32 x 5) raises before
    the chain's first launch; the LayerNorm kernel itself also raises for
    it."""
    from vgqa_tpu_torch.ops.kernels import build
    from vgqa_tpu_torch.ops.kernels import swin_block as sb

    rng = np.random.RandomState(0)
    ws = [torch.from_numpy(w).to(cuda).bfloat16() for w in _block_weights(rng, 160)]
    canvas = torch.randn(1, 8, 7, 7, 160, device=cuda).bfloat16()
    bias = torch.zeros(5, 392, 392, device=cuda).bfloat16()
    before = swin_block_canvas.launches
    with pytest.raises(ValueError, match="layernorm"):
        swin_block_canvas(canvas, *ws, bias, 5, (8, 7, 7), (0, 0, 0))
    assert swin_block_canvas.launches == before
    x = canvas.reshape(-1, 160)
    with pytest.raises(RuntimeError, match="layernorm"):
        sb._ln_rows(build.load_library(), build.stream_handle(cuda), x, None, ws[0], ws[1],
                    None, 1, torch.empty_like(x), x.shape[0], 160)


def _check_k1_and_k1f(cuda, shape, heads, shift, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    D, H, W, C = shape
    window, shift = tvs._adjust_window((D, H, W), (8, 7, 7), shift)
    dims_p = tuple(d + (-d) % w for d, w in zip((D, H, W), window))
    N = window[0] * window[1] * window[2]
    rng = np.random.RandomState(C + sum(shift))
    ws = [torch.from_numpy(w).to(cuda).to(dtype) for w in _block_weights(rng, C)]
    g = torch.Generator(device=cuda).manual_seed(C + sum(shift))
    canvas = torch.randn(2, *dims_p, C, generator=g, device=cuda).to(dtype)
    bias = (0.2 * torch.randn(heads, N, N, generator=g, device=cuda)).to(dtype)
    region = (torch.from_numpy(tvs._region_partition(dims_p, window, shift)).to(cuda)
              if any(shift) else None)
    valid = tvs._valid_partition((D, H, W), dims_p, window, shift)
    valid = None if valid is None else torch.from_numpy(valid).to(cuda)
    gates = torch.tensor([[1.1111, 1.25], [0.0, 1.0]], device=cuda)
    out = swin_block_canvas(canvas, *ws, bias, heads, window, shift,
                            region=region, valid=valid, gates=gates)
    ref = swin_block_canvas_reference(canvas.float(), *[w.float() for w in ws], bias.float(),
                                      heads, window, shift, region=region, valid=valid,
                                      gates=gates)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) < (F32_REL if dtype == torch.float32 else CUDA_REL)
    del ref
    k1 = swin_block_canvas(canvas, *ws, bias, heads, window, shift, region=region,
                           valid=valid)
    rolled = torch.roll(canvas, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    fused = swin_block_fused(tvs.window_partition(rolled, window), *ws, bias, heads,
                             region=region, valid=valid)
    torch.cuda.synchronize()
    assert (tvs.window_reverse(fused, window, 2, *dims_p).float() - k1.float()).abs().max() == 0


# ---- head dims below the kernels' (padded per head); what padding cannot reach raises ----

@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_attention_small_head_dims_cuda(cuda, dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(dh)
    H, S = 4, 130
    q, k, v = (torch.randn(16, S, H * dh, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    kv = (torch.rand(16, S, generator=g, device=cuda) > 0.2).float()
    kv[:, 0] = 1.0
    before = window_attention.launches
    out = window_attention(q, k, v, key_valid=kv, num_heads=H)
    ref = window_attention_reference(q.float(), k.float(), v.float(), key_valid=kv,
                                      num_heads=H)
    assert window_attention.launches == before + 1
    assert _rel_err(out, ref) < (1e-4 if dtype == torch.float32 else CUDA_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_mha_train_small_head_dims_cuda(cuda, dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(dh)
    H, L = 4, 124
    q, k, v = (torch.randn(8, L, H * dh, generator=g, device=cuda).to(dtype).requires_grad_()
               for _ in range(3))
    mask = torch.ones(8, L, dtype=torch.bool, device=cuda)
    mask[1, 100:] = False
    do = torch.randn(8, L, H * dh, generator=g, device=cuda).to(dtype)
    before = (flash_mha_train.fwd_launches, flash_mha_train.bwd_launches)
    out = flash_mha_train(q, k, v, H, key_mask=mask, dropout_rate=0.1, seed=5)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_mha_train.fwd_launches, flash_mha_train.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    # the plain version on the CPU draws the same keep mask (folded row, query, key)
    qc, kc, vc = (t.detach().float().cpu().requires_grad_() for t in (q, k, v))
    ref = flash_mha_train(qc, kc, vc, H, key_mask=mask.cpu(), dropout_rate=0.1, seed=5)
    ref_grads = torch.autograd.grad(ref, (qc, kc, vc), do.float().cpu())
    tol = 1e-4 if dtype == torch.float32 else CUDA_REL
    assert _rel_err(out.cpu(), ref) < tol
    for a, b in zip(grads, ref_grads):
        assert _rel_err(a.cpu(), b) < (1e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16])
def test_flash_mha_small_head_dims_cuda(cuda, dh):
    g = torch.Generator(device=cuda).manual_seed(dh)
    H = 4
    q, k, v = (torch.randn(8, 65, H * dh, generator=g, device=cuda).bfloat16() for _ in range(3))
    before = flash_mha.launches
    out = flash_mha(q, k, v, H)
    assert flash_mha.launches == before + 1
    assert _rel_err(out, flash_mha_reference(q.float(), k.float(), v.float(), H)) < CUDA_REL
    with pytest.raises(TypeError, match="bfloat16"):           # K4 takes bf16 only
        flash_mha(q.float(), k.float(), v.float(), H)
    assert flash_mha.launches == before + 1


@pytest.mark.cuda
def test_flash_gqa_small_head_dim_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(8, 40, 16, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 96, 16, generator=g, device=cuda).bfloat16() for _ in range(2))
    before = flash_gqa_causal.launches
    out = flash_gqa_causal(q, k, v, 30, 60)
    assert flash_gqa_causal.launches == before + 1
    ref = flash_gqa_causal_reference(q.float(), k.float(), v.float(), 30, 60)
    assert _rel_err(out, ref) < CUDA_REL


def _tiny_grounding_cfg(**opts):
    import os

    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "grounding_vidstg_tiny.yaml"))
    cfg.OUTPUT_DIR = ""
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


@pytest.mark.cuda
def test_tiny_grounding_serves_with_kernel_routes_cuda(cuda):
    """configs/grounding_vidstg_tiny.yaml on the card: the encoder's heads of
    8 run K2 padded. The tiny Swin's first stages (C 8, 16) are not widths
    of K1's chain: with its route on the forward raises before a launch, so
    the Swin tower runs its plain route (``vid.use_kernels`` False)."""
    from vgqa_tpu_torch.inference.grounding import load_model, predict_many

    loaded = load_model(_tiny_grounding_cfg(), device=cuda)
    frames = np.random.RandomState(0).randint(0, 256, (16, 64, 64, 3), np.uint8)
    request = {"frames": frames, "fps": 8.0, "ori_size": (48, 80), "query": "a red ball"}
    before = (swin_block_canvas.launches, window_attention.launches)
    with pytest.raises(ValueError, match="layernorm"):
        predict_many([request], loaded=loaded)
    assert swin_block_canvas.launches == before[0]
    loaded.model.vid.use_kernels = False
    before = (swin_block_canvas.launches, window_attention.launches)
    out = predict_many([request], loaded=loaded)[0]
    assert len(out["tube"]) == 16
    assert (swin_block_canvas.launches - before[0], window_attention.launches - before[1]) == (0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_grounding_trains_with_kernel_routes_cuda(cuda, dtype):
    """The tiny config trains on the card with K3 on its heads of 8
    (padded); the Swin tower takes its plain route, as when serving."""
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer

    cfg = _tiny_grounding_cfg(**{"TPU.TRAIN_DTYPE": dtype})
    trainer = Trainer(cfg, device=cuda, seed=0)
    trainer.setup(max_iter=10)
    trainer.state.model.vid.use_kernels = False
    before = (swin_block_canvas.launches, flash_mha_train.fwd_launches,
              flash_mha_train.bwd_launches)
    logged = trainer.fit([synthetic_batch(cfg)], steps=2)
    assert all(np.isfinite(x["loss"]) for x in logged)
    assert (swin_block_canvas.launches - before[0], flash_mha_train.fwd_launches - before[1],
            flash_mha_train.bwd_launches - before[2]) == (0, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_qa_chats_with_kernel_routes_cuda(cuda, dtype):
    """QA ``__tiny__`` (ViT heads of 8, LLM heads of 16): in bf16 K4 and K5
    run, padded; K4 and K5 take bf16 only, so the float32 engine raises
    with its kernel routes on and chats with them off."""
    from vgqa_tpu_torch.qa import LLMConfig, QAEngine, ViTConfig
    from vgqa_tpu_torch.qa.engine import GenerationConfig

    eng = QAEngine.init_random(LLMConfig.tiny(), ViTConfig.tiny(), device=cuda, dtype=dtype)
    tiles = np.random.RandomState(1).randint(0, 256, (2, 32, 32, 3), np.uint8)
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0, do_sample=False)
    before = (flash_mha.launches, flash_gqa_causal.launches)
    if dtype == torch.float32:
        with pytest.raises(TypeError, match="bfloat16"):
            eng.chat(tiles, "what is it?", gen)
        eng.use_kernels = False
    answer = eng.chat(tiles, "what is it?", gen)
    assert isinstance(answer, str)
    ran = (flash_mha.launches - before[0], flash_gqa_causal.launches - before[1])
    if dtype == torch.float32:
        assert ran == (0, 0)
    else:
        assert ran[0] > 0 and ran[1] > 0
