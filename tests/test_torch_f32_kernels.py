"""The float32 forms of the grounding kernels (K1 / K1', K2, K3) and the K4
wrapper's operand checks, on the CPU.

* The shared dtype rule of ``ops/kernels/dtypes.py``: bf16 and f32 reach
  the kernels, anything else raises ``TypeError`` (in the rule, in the K2
  and K3 wrappers' CUDA checks).
* K3 at rate 0.1 in float32 against the Pallas kernel of vgqa_tpu in
  interpret mode, forward and backward: the Pallas ``_keep_mask`` is
  replaced, in this test only, by the port's keep function written in jnp
  (word j mod 4 of Philox4x32-10 with key (seed + row, 0) and counter
  (i, j / 4)), compared by Pallas's own threshold test; so both sides
  drop the same elements and the comparison is exact up to summation order
  (atol 1e-5, as the rate-0 f32 cases of test_torch_train_kernels.py).
* The plain K3 forward draws the same keep bits for bf16 and f32 inputs.
* K4's operand checks (head dim, dtype, strides, alignment) on the path
  that feeds its tensor maps.
* The port's YAML reader for config files (the card machine has no PyYAML)
  merges every file of configs/ as PyYAML does, and ``CfgNode.dump`` writes
  YAML that it and PyYAML read back alike.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgqa_tpu.ops.pallas.flash_train as pallas_flash_train
from vgqa_tpu_torch.config import build_default_cfg
from vgqa_tpu_torch.config import node as cfg_node
from vgqa_tpu_torch.ops.kernels import flash_train, window_attention
from vgqa_tpu_torch.ops.kernels.dtypes import KERNEL_DTYPES, check_kernel_dtype
from vgqa_tpu_torch.ops.kernels.flash_attention import flash_mha_operands
from vgqa_tpu_torch.ops.kernels.flash_train import (
    flash_mha_train,
    flash_train_fwd,
    keep_mask,
    pack_keep_bits,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS, DH = 2, 32


@pytest.mark.parametrize("dtype,ok", [(torch.bfloat16, True), (torch.float32, True),
                                      (torch.float16, False), (torch.float64, False)])
def test_kernel_dtype_rule(dtype, ok):
    assert (dtype in KERNEL_DTYPES) == ok
    if ok:
        check_kernel_dtype("k", dtype)
    else:
        with pytest.raises(TypeError):
            check_kernel_dtype("k", dtype)


@pytest.mark.parametrize("dtype,ok", [(torch.bfloat16, True), (torch.float32, True),
                                      (torch.float16, False)])
def test_wrappers_share_the_dtype_rule(dtype, ok):
    """The K3 and K2 wrappers' CUDA-side checks run before any launch, so
    they can be read on CPU tensors: bf16 and f32 pass, f16 raises."""
    q = torch.zeros(2, 8, HEADS * DH, dtype=dtype)
    mask = torch.ones(2, 8, dtype=torch.bool)
    if ok:
        flash_train._check_cuda(q, q, q, mask, HEADS)
    else:
        with pytest.raises(TypeError):
            flash_train._check_cuda(q, q, q, mask, HEADS)
        with pytest.raises(TypeError):
            window_attention.launch(q, q, q, q.clone(), HEADS, 1.0)


def _mulhilo(a, m):
    """(hi, lo) of a * m for uint32 jnp arrays and a constant m, in 16-bit
    pieces (no 64-bit types)."""
    m_lo, m_hi = jnp.uint32(m & 0xFFFF), jnp.uint32(m >> 16)
    a_lo, a_hi = a & jnp.uint32(0xFFFF), a >> 16
    p0, p1, p2, p3 = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (p0 >> 16) + (p1 & jnp.uint32(0xFFFF)) + (p2 & jnp.uint32(0xFFFF))
    return p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16), a * jnp.uint32(m)


def _port_keep_mask(seed, shape, rate, interpret):
    """The port's keep decisions for one folded row as a replacement for the
    Pallas ``_keep_mask``: the bits are word j % 4 of Philox4x32-10 with key
    (seed + row, 0) and counter (i, j // 4, 0, 0); the comparison is
    Pallas's own."""
    i = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
    c0, c1 = i, j >> 2
    c2 = c3 = jnp.zeros(shape, jnp.uint32)
    k0 = jnp.full(shape, jax.lax.convert_element_type(seed, jnp.uint32))
    k1 = jnp.zeros(shape, jnp.uint32)
    for r in range(10):
        if r:
            k0, k1 = k0 + jnp.uint32(0x9E3779B9), k1 + jnp.uint32(0xBB67AE85)
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    e = j & jnp.uint32(3)
    bits = jnp.where(e == 0, c0, jnp.where(e == 1, c1, jnp.where(e == 2, c2, c3)))
    u = (bits >> 8).astype(jnp.float32)
    return u * (1.0 / (1 << 24)) >= rate


@pytest.mark.parametrize("Lq,Lk", [(124, 124), (70, 130)])
def test_f32_dropout_matches_pallas_interpret(Lq, Lk, monkeypatch):
    rate, seed, W = 0.1, 4321, 3
    rng = np.random.RandomState(Lq + Lk)
    q = rng.randn(W, Lq, HEADS * DH).astype(np.float32)
    k, v = (rng.randn(W, Lk, HEADS * DH).astype(np.float32) for _ in range(2))
    mask = rng.rand(W, Lk) > 0.25
    mask[:, 0] = True
    mask[:, -3:] = False
    cot = rng.randn(W, Lq, HEADS * DH).astype(np.float32)

    monkeypatch.setattr(pallas_flash_train, "_keep_mask", _port_keep_mask)
    jax.clear_caches()

    def jloss(q, k, v):
        o = pallas_flash_train.flash_mha_train(
            q, k, v, HEADS, key_mask=jnp.asarray(mask), dropout_rate=rate, seed=seed,
            interpret=True)
        return (o * cot).sum(), o

    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jax.clear_caches()

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_mha_train(qt, kt, vt, HEADS, key_mask=torch.from_numpy(mask),
                          dropout_rate=rate, seed=seed)
    (out * torch.from_numpy(cot)).sum().backward()
    got = [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]
    want = [np.asarray(a) for a in (out_j, *grads_j)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
    # dropout really dropped: rate 0 gives another output
    plain = flash_mha_train(*(torch.from_numpy(a) for a in (q, k, v)), HEADS,
                            key_mask=torch.from_numpy(mask))
    assert (plain - out.detach()).abs().max().item() > 1e-3


@pytest.mark.parametrize("Lq,Lk", [(124, 124), (70, 130), (418, 418)])
def test_keep_bits_equal_for_bf16_and_f32(Lq, Lk):
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(2, Lq, HEADS * DH).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, Lk, HEADS * DH).astype(np.float32))
    args = (None, -77, 0.1, DH ** -0.5, HEADS)
    bits32 = flash_train_fwd(q, k, k, *args)[2]
    bits16 = flash_train_fwd(q.bfloat16(), k.bfloat16(), k.bfloat16(), *args)[2]
    assert torch.equal(bits32, bits16)
    assert torch.equal(bits32, pack_keep_bits(keep_mask(-77, 2 * HEADS, Lq, Lk, 0.1)))


def _qkv(B=2, L=9, H=3, D=64, dtype=torch.bfloat16):
    qkv = torch.zeros(B, L, 3 * H * D, dtype=dtype)
    return qkv.split(H * D, dim=-1)


def test_flash_mha_operands_take_strided_qkv_views():
    q, k, v = _qkv()
    mask = torch.ones(2, 9, dtype=torch.bool)
    q3, k3, v3, out, m = flash_mha_operands(q, k, v, 3, mask)
    assert q3.data_ptr() == q.data_ptr() and q3.stride() == q.stride() == (9 * 576, 576, 1)
    assert out.shape == (2, 9, 192) and out.is_contiguous()
    assert m.dtype == torch.uint8 and m.shape == (2, 9)


@pytest.mark.parametrize("case", ["head_dim_32", "float32", "odd_row_stride", "misaligned",
                                  "shape"])
def test_flash_mha_operands_reject(case):
    q, k, v = _qkv()
    heads, exc = 3, ValueError
    if case == "head_dim_32":
        heads = 6
    elif case == "float32":
        q, k, v = _qkv(dtype=torch.float32)
        exc = TypeError
    elif case == "odd_row_stride":
        base = torch.zeros(2, 9, 3 * 192 + 4, dtype=torch.bfloat16)
        q, k, v = base[..., :192], base[..., 192:384], base[..., 384:576]
    elif case == "misaligned":
        base = torch.zeros(2, 9, 3 * 192 + 8, dtype=torch.bfloat16)
        q, k, v = base[..., 1:193], base[..., 193:385], base[..., 385:577]
    else:
        k = k[:, :5]
    with pytest.raises(exc):
        flash_mha_operands(q, k, v, heads)


def _block_pyyaml(monkeypatch):
    """Make ``import yaml`` fail, as on a host without PyYAML."""
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no PyYAML")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_merges_like_pyyaml(path, monkeypatch):
    want = build_default_cfg()
    want.merge_from_file(path)                        # PyYAML, present here
    _block_pyyaml(monkeypatch)
    got = build_default_cfg()
    got.merge_from_file(path)
    assert got.to_dict() == want.to_dict()


def test_yaml_reader_subset():
    text = ("# top\nA:\n  B: 1   # one\n  C: [9, 11]\n  D: 'x # y'\n  E:\nF: True\n"
            "G: 2e-4\nH: some/path/\n")
    assert cfg_node._yaml_mapping(text) == {
        "A": {"B": 1, "C": [9, 11], "D": "x # y", "E": None}, "F": True, "G": 2e-4,
        "H": "some/path/"}
    with pytest.raises(ValueError):
        cfg_node._yaml_mapping("A:\n  - 1\n")


def _lists(tree):
    if isinstance(tree, dict):
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


@pytest.mark.parametrize("overlay", [None, "grounding_vidstg.yaml"])
def test_dump_reads_back_alike_without_pyyaml(overlay, tmp_path, monkeypatch):
    import yaml

    cfg = build_default_cfg()
    if overlay:
        cfg.merge_from_file(os.path.join(ROOT, "configs", overlay))
    cfg.OUTPUT_DIR = 'runs/a "b # c\\d'
    cfg.SOLVER.BASE_LR = 1e-05
    text = cfg.dump()
    want = _lists(cfg.to_dict())
    assert cfg_node._yaml_mapping(text) == want
    assert yaml.safe_load(text) == want
    path = tmp_path / "dumped.yaml"
    path.write_text(text)
    _block_pyyaml(monkeypatch)
    got = build_default_cfg()
    got.merge_from_file(str(path))
    assert got.to_dict() == cfg.to_dict()
    assert got.dump() == text
