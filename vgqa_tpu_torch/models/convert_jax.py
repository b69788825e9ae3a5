"""Carry a JAX parameter tree over to this package's modules.

The modules of ``vgqa_tpu_torch.models`` use the flax submodule names, so a
flax tree (``{'params': {...}}`` or its inner dict, numpy or array leaves)
becomes a ``state_dict`` by one generic walk with a rule per kind of leaf:

* Dense ``kernel`` [in, out]   -> ``weight`` [out, in]
* Conv ``kernel`` HWIO         -> ``weight`` OIHW
* LayerNorm/GroupNorm/FrozenAffine ``scale`` -> ``weight``
* Embed ``embedding``          -> ``weight``
* ``bias`` and the raw parameters below keep their name and layout:
  ``patch_embed_kernel``, ``patch_embed_bias``,
  ``relative_position_bias_table``, ``row_embed``, ``col_embed``,
  ``time_embed``, and the QA vision tower's ``ls1``, ``ls2``,
  ``cls_token``, ``pos_embed``.
* Inside a quantized Dense (a dict holding ``kernel_q`` or ``kernel_q4``,
  ``qa/quant.py``) every leaf keeps its name, layout and dtype:
  ``kernel_q`` int8 [in, out], ``kernel_q4`` int8 [in/2, out] (the
  split-half pack), and ``scale`` / ``scale4``, which there are
  quantization scales (f32), not norm weights.

Float leaves become float32, except torch tensors (an exported tree that
``torch.load`` read), which keep their dtype and are not copied: a
transposed kernel is a view, and ``load_state_dict`` copies it into the
module once, so a bf16 tree is never widened on the host. Any other leaf
raises. A reference checkpoint loads along
``vgqa_tpu.models.convert_grounding.convert_grounding_reference`` (numpy,
in the JAX package) followed by ``state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_AS_STORED = {"bias", "patch_embed_kernel", "patch_embed_bias",
              "relative_position_bias_table", "row_embed", "col_embed",
              "time_embed", "ls1", "ls2", "cls_token", "pos_embed"}
_QUANT_LEAVES = {"kernel_q": np.int8, "kernel_q4": np.int8, "scale": np.float32,
                 "scale4": np.float32}


def _convert_quant_leaf(path, value):
    name = path[-1]
    if name not in _QUANT_LEAVES:
        raise KeyError(f"{'/'.join(path)}: no rule maps this leaf of a quantized Dense")
    arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
    dtype = arr.numpy().dtype if isinstance(arr, torch.Tensor) else arr.dtype
    if dtype != _QUANT_LEAVES[name]:
        raise TypeError(f"{'/'.join(path)}: {dtype}, expected {_QUANT_LEAVES[name]}")
    return name, arr


def _convert_leaf(path, value):
    name = path[-1]
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            raise TypeError(f"{'/'.join(path)}: {value.dtype}, expected a float tensor")
        arr, permute = value, value.permute
    else:
        arr = np.asarray(value, dtype=np.float32)
        permute = arr.transpose
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", permute(1, 0)
        if arr.ndim == 4:
            return "weight", permute(3, 2, 0, 1)
        raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    if name in _AS_STORED:
        return name, arr
    raise KeyError(f"{'/'.join(path)}: no rule maps this leaf")


def state_dict_from_jax(params: Mapping,
                        module: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> ``state_dict`` (float32 tensors, torch leaves in
    their own dtype; int8 and f32 as stored inside quantized Dense dicts).

    With ``module`` given, the result must name exactly the module's
    parameters with the same shapes; a missing, extra or misshapen entry
    raises."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path, quant=False):
        if isinstance(node, Mapping):
            quant = "kernel_q" in node or "kernel_q4" in node
            for k, v in node.items():
                walk(v, path + (str(k),), quant)
            return
        name, arr = (_convert_quant_leaf if quant else _convert_leaf)(path, node)
        out[".".join(path[:-1] + (name,))] = (
            arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr)))

    walk(params, ())
    if module is not None:
        expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(f"JAX tree does not match the module: missing {missing}, "
                           f"unmapped {extra}")
        for k, shape in expected.items():
            if tuple(out[k].shape) != shape:
                raise ValueError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
    return out
