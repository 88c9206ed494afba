"""The feature net's convolutions, K5: the hand-written CUDA kernel of
``csrc/conv2d.cu`` (forward and input gradient), their plain PyTorch
versions, and the PyTorch operators that join them under autograd.

It replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
It exists because cuDNN's float32 route for the ResUNet's shapes (TF32 off)
is an FFT convolution on the CUDA cores, most of an attack iteration.

``convolution(x, weight, bias, stride)`` is a "valid" convolution (no
padding, dilation 1, one group) of ``x [V, C, H, W]`` with ``weight [N, C,
kh, kw]``, plus ``bias [N]`` or None: the ResUNet pads (reflect) with
``F.pad`` first, so that autograd's pad backward folds the gradient's border.
``convolution_input_grad(grad, weight, height, width, stride)`` is its
gradient with respect to ``x``; the stride-2 case is computed as four
stride-1 problems, one per parity of the input pixel, so that every entry is
written once. Both are ``torch.library`` operators (``nerfool_torch::
convolution``, ``nerfool_torch::convolution_input_grad``), joined by an
``autograd.Function``: the launches run inside operators whose names hold
"convolution", which is what the benchmark's traced readers take for the
feature net. The weight and bias gradients are asked of
``aten::convolution_backward`` with only their mask set, and only where
autograd needs them (the trainer): the attack freezes the parameters.

Routing, by what the call can observe (``takes``; ``models/layers.py``
``Conv2d``):

- float32 on a CUDA device: the kernel (``conv2d_forward``,
  ``conv2d_input_grad``, each counting its launches), built by nvcc at first
  use. Products on the tensor cores, float32 as three TF32 products, the
  weights packed and split once a call;
- float32 or float64 on the CPU: the plain versions (``conv2d_plain``,
  ``conv2d_input_grad_plain``), the kernel's arithmetic in ``F.conv2d``;
- anything else (bfloat16 features, ``--feature_dtype bfloat16``): the
  library's ``F.conv2d``, cuDNN on a card.

Nothing falls back from the kernel to another route: what the kernel does
not take raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from nerfool_tpu_torch.ops.build import load_library

# what ``csrc/conv2d.cu`` returns for a shape it does not take: a gathered
# tensor whose channels are not a multiple of its k step (16) goes through a
# table of at most GEN_MAX_K k values (the stem's 3 channels: 147)
_CUDA_ERROR_INVALID_VALUE = 1


def conv2d_plain(x, weight, bias, stride):
    """The forward in plain PyTorch: a valid convolution."""
    return F.conv2d(x, weight, bias, stride)


def input_grad_problems(kh, kw, stride, height, width):
    """The stride-1 problems of the input gradient, as the kernel plans
    them: per parity (a, b) of the input pixel, (a, b, taps down, taps
    across, rows, columns of that parity). A parity with no taps (a 1x1
    kernel at odd pixels) has zeros there."""
    out = []
    for a in range(stride):
        for b in range(stride):
            out.append((a, b, -(-(kh - a) // stride), -(-(kw - b) // stride),
                        -(-(height - a) // stride), -(-(width - b) // stride)))
    return out


def conv2d_input_grad_plain(grad, weight, height, width, stride):
    """The gradient of ``conv2d_plain``'s input ``[V, C, height, width]``
    from ``grad [V, N, Ho, Wo]``, as the kernel computes it: per parity (a,
    b) of the input pixel, the stride-1 correlation of ``grad`` (zeros
    around it) with the sub-kernel ``weight[:, :, a::stride, b::stride]``
    flipped and transposed, written at ``(stride i + a, stride j + b)``."""
    v, _, ho, wo = grad.shape
    c = weight.shape[1]
    out = grad.new_zeros(v, c, height, width)
    for a, b, th, tw, hi, wi in input_grad_problems(
            weight.shape[2], weight.shape[3], stride, height, width):
        if th == 0 or tw == 0:
            continue
        sub = weight[:, :, a::stride, b::stride].flip(2, 3).transpose(0, 1)
        padded = F.pad(grad, (tw - 1, wi - wo, th - 1, hi - ho))
        out[:, :, a::stride, b::stride] = F.conv2d(padded, sub)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("conv2d")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.conv2d_forward.argtypes = [vp] * 5 + [ci] * 10 + [vp]
    lib.conv2d_forward.restype = ci
    lib.conv2d_input_grad.argtypes = [vp] * 4 + [ci] * 10 + [vp]
    lib.conv2d_input_grad.restype = ci
    lib.conv2d_wpack_floats.argtypes = [ci] * 6
    lib.conv2d_wpack_floats.restype = ctypes.c_longlong
    return lib


def build():
    """Build ``csrc/conv2d.cu`` (``ops/build.py``) and load it."""
    return _lib()


def _check(x, weight, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: CUDA tensors only, got {x.device}")
    for name, t in (("input", x), ("weight", weight)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {x.device} and "
                             f"{t.device}")


def _check_size(what, *tensors):
    for t in tensors:
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{what}: {tuple(t.shape)} has 2^31 entries or "
                             f"more (the kernel's offsets are 32-bit)")


def _raise_on(what, err):
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{what}: the kernel refused the shape "
                         f"(cudaErrorInvalidValue; e.g. channels not a "
                         f"multiple of 16 whose taps exceed the gather "
                         f"table of csrc/conv2d.cu)")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def conv2d_forward(x, weight, bias, stride):
    """The kernel's forward: ``conv2d_plain`` on CUDA float32 tensors
    (counted in ``conv2d_forward.launches``)."""
    _check(x, weight, "conv2d_forward")
    v, c, h, w = x.shape
    n, wc, kh, kw = weight.shape
    if wc != c:
        raise ValueError(f"conv2d_forward: weight {tuple(weight.shape)} for "
                         f"{c} input channels")
    if bias is not None and (bias.shape != (n,) or bias.dtype != x.dtype
                             or bias.device != x.device):
        raise ValueError(f"conv2d_forward: bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    if stride < 1 or h < kh or w < kw:
        raise ValueError(f"conv2d_forward: a {kh}x{kw} kernel at stride "
                         f"{stride} over {h}x{w}")
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    x, weight = x.contiguous(), weight.detach().contiguous()
    out = torch.empty(v, n, ho, wo, dtype=x.dtype, device=x.device)
    _check_size("conv2d_forward", x, out)
    lib = _lib()
    wpack = torch.empty(lib.conv2d_wpack_floats(0, c, n, kh, kw, stride),
                        dtype=torch.float32, device=x.device)
    b = None if bias is None else bias.detach().contiguous()
    with torch.cuda.device(x.device):
        err = lib.conv2d_forward(
            x.data_ptr(), weight.data_ptr(), None if b is None else
            b.data_ptr(), out.data_ptr(), wpack.data_ptr(), v, c, h, w, n,
            kh, kw, stride, ho, wo, _stream(x.device))
    _raise_on("conv2d_forward", err)
    conv2d_forward.launches += 1
    return out


conv2d_forward.launches = 0


def conv2d_input_grad(grad, weight, height, width, stride):
    """The kernel's input gradient: ``conv2d_input_grad_plain`` on CUDA
    float32 tensors (counted in ``conv2d_input_grad.launches``, one launch
    for all parities)."""
    _check(grad, weight, "conv2d_input_grad")
    v, n, ho, wo = grad.shape
    wn, c, kh, kw = weight.shape
    if wn != n:
        raise ValueError(f"conv2d_input_grad: weight {tuple(weight.shape)} "
                         f"for a gradient of {n} channels")
    if ((height - kh) // stride + 1, (width - kw) // stride + 1) != (ho, wo):
        raise ValueError(f"conv2d_input_grad: a {ho}x{wo} gradient is not "
                         f"the output of {height}x{width} at stride "
                         f"{stride} with a {kh}x{kw} kernel")
    grad, weight = grad.contiguous(), weight.detach().contiguous()
    out = torch.empty(v, c, height, width, dtype=grad.dtype,
                      device=grad.device)
    _check_size("conv2d_input_grad", grad, out)
    lib = _lib()
    wpack = torch.empty(lib.conv2d_wpack_floats(1, c, n, kh, kw, stride),
                        dtype=torch.float32, device=grad.device)
    with torch.cuda.device(grad.device):
        err = lib.conv2d_input_grad(
            grad.data_ptr(), weight.data_ptr(), out.data_ptr(),
            wpack.data_ptr(), v, n, ho, wo, c, kh, kw, stride, height, width,
            _stream(grad.device))
    _raise_on("conv2d_input_grad", err)
    conv2d_input_grad.launches += 1
    return out


conv2d_input_grad.launches = 0


# the operators: plain versions on the CPU, the kernel on a card (each
# looked up when called, so that a test can stand in for it). Defined with
# ``torch.library.Library`` and joined by an ``autograd.Function``
# (``torch.library.custom_op``'s first call imports the compiler stack,
# seconds of set-up)
_OPS = torch.library.Library("nerfool_torch", "DEF")
_OPS.define("convolution(Tensor x, Tensor weight, Tensor? bias, int stride) "
            "-> Tensor")
_OPS.define("convolution_input_grad(Tensor grad, Tensor weight, int height, "
            "int width, int stride) -> Tensor")
_OPS.impl("convolution", lambda *a: conv2d_plain(*a), "CPU")
_OPS.impl("convolution", lambda *a: conv2d_forward(*a), "CUDA")
_OPS.impl("convolution_input_grad", lambda *a: conv2d_input_grad_plain(*a),
          "CPU")
_OPS.impl("convolution_input_grad", lambda *a: conv2d_input_grad(*a), "CUDA")


class Convolution(torch.autograd.Function):
    """``nerfool_torch::convolution`` under autograd: the input gradient
    through ``nerfool_torch::convolution_input_grad``; the weight and bias
    gradients through ``aten::convolution_backward`` with only their mask
    set, and only where autograd needs them."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.has_bias = stride, bias is not None
        return torch.ops.nerfool_torch.convolution(x, weight, bias, stride)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx = gw = gb = None
        if need_x:
            gx = torch.ops.nerfool_torch.convolution_input_grad(
                grad, weight, x.shape[2], x.shape[3], ctx.stride)
        if need_w or need_b:
            _, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None,
                [ctx.stride] * 2, [0, 0], [1, 1], False, [0, 0], 1,
                [False, need_w, need_b])
        return gx, gw, gb, None


def convolution(x, weight, bias, stride):
    """A valid convolution: the kernel for CUDA tensors, the plain version
    for CPU ones, differentiable in every tensor argument."""
    return Convolution.apply(x, weight, bias, stride)


def takes(x):
    """Whether a convolution of ``x`` goes through ``convolution`` (the
    kernel or its plain version) rather than the library's ``F.conv2d``."""
    if x.device.type == "cuda":
        return x.dtype == torch.float32
    return x.device.type == "cpu" and x.dtype in (torch.float32,
                                                  torch.float64)
