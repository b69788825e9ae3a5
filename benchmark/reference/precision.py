"""The controls' precisions: the reference computed one step below the
precision its configuration states.

``Float8Products()`` is a torch function mode under which every matrix
product and convolution (``F.linear``, ``F.conv2d``, ``matmul``, ``mm``,
``bmm``, ``einsum``, ``addmm``, ``baddbmm``) takes its operands rounded to
float8 e4m3 with one scale per tensor (its absolute maximum at 448): the
control of a bfloat16 configuration. ``tf32()`` lets cuBLAS and cuDNN
compute float32 products in TF32: the control of a float32 configuration
with TF32 off. ``float32()`` holds TF32 off, as the reference itself runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def to_fp8(x):
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


_BOTH = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.bmm,
         torch.Tensor.mm, torch.Tensor.bmm}
_FIRST_TWO = {F.linear, F.conv2d, F.conv3d, F.conv1d}
_LAST_TWO = {torch.addmm, torch.baddbmm}


class Float8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _BOTH:
            args = tuple(to_fp8(a) for a in args)
        elif func in _FIRST_TWO:
            args = (to_fp8(args[0]), to_fp8(args[1])) + tuple(args[2:])
            if "weight" in kwargs:
                kwargs["weight"] = to_fp8(kwargs["weight"])
        elif func in _LAST_TWO:
            args = (args[0], to_fp8(args[1]), to_fp8(args[2])) + tuple(args[3:])
        elif func is torch.einsum:
            ops = args[1:]
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = (type(ops[0])(to_fp8(o) for o in ops[0]),)
            else:
                ops = tuple(to_fp8(o) for o in ops)
            args = (args[0],) + ops
        return func(*args, **kwargs)


@contextlib.contextmanager
def _tf32_flags(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def tf32():
    return _tf32_flags(True)


def float32():
    return _tf32_flags(False)
