"""pixelNeRF's 512-wide ``ResnetFC`` layers, K6: the hand-written CUDA kernel
of ``csrc/linear.cu`` (forward and input gradient), their plain PyTorch
versions, the PyTorch operators that join them under autograd, and the
residual block built from them.

It replaces no TPU kernel: the JAX package leaves these products to XLA. It
exists because cuBLAS's float32 route (TF32 off) runs them on the CUDA
cores, the largest part of a pixelNeRF attack iteration.

``dense(x, weight, bias, addend, relu)`` is ``act(x) weight^T + bias (+
addend)`` over the last dimension of ``x [..., K]``, ``act`` ReLU where
``relu``, else the identity. ``dense_input_grad(grad, weight, mask,
addend)`` is ``(grad weight) * [mask > 0] (+ addend)``: the gradient of
``dense``'s input, with ``mask`` its ``x`` where it took a ReLU (None
otherwise), plus another gradient of the same tensor. Both are
``torch.library`` operators (``nerfool_torch::dense``,
``nerfool_torch::dense_input_grad``; no "convolution" in their names, which
the benchmark's reader of the feature net takes). ``resnet_block`` joins them
under an ``autograd.Function``: ``u + fc_1(relu(fc_0(relu(u))))`` with ``u =
h + lin_z(taps)`` is three launches forward (``lin_z`` with ``h`` as addend,
``fc_0``, ``fc_1`` with ``u`` as addend) and three backward (``fc_1``'s input
gradient masked by ``fc_0``'s output, ``fc_0``'s masked by ``u`` plus the
residual's gradient, ``lin_z``'s), with no elementwise pass between them;
without ``lin_z`` two each way. The weight and bias gradients are plain
PyTorch, and only where autograd asks for them (the trainer): the attack
freezes the parameters.

Routing, by what the call can observe (``takes``; ``models/pixelnerf.py``
``ResnetBlockFC``):

- float32 on a CUDA device: the kernel (``dense_forward``,
  ``dense_input_grad``, each counting its launches), built by nvcc at
  first use. Products on the tensor cores, float32 as three TF32 products,
  the weights split once a call;
- float32 or float64 on the CPU: the plain versions (``dense_plain``,
  ``dense_input_grad_plain``);
- anything else (bfloat16): the module's ``F.linear`` layers.

Nothing falls back from the kernel to another route: a shape the kernel does
not take (an inner size that is not a multiple of 32, an output width that is
not a multiple of 128) raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from nerfool_tpu_torch.ops.build import load_library

# what ``csrc/linear.cu`` returns for a shape it does not take
_CUDA_ERROR_INVALID_VALUE = 1


def dense_plain(x, weight, bias, addend, relu):
    """The forward in plain PyTorch: ``F.linear``, then the addend."""
    y = F.linear(F.relu(x) if relu else x, weight, bias)
    return y if addend is None else y + addend


def dense_input_grad_plain(grad, weight, mask, addend):
    """The input gradient in plain PyTorch: ``grad weight``, zero where
    ``mask <= 0`` (a ReLU's input), then the addend."""
    g = torch.matmul(grad, weight)
    if mask is not None:
        g = torch.where(mask > 0, g, g.new_zeros(()))
    return g if addend is None else g + addend


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("linear")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dense_forward.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.dense_forward.restype = ci
    lib.dense_input_grad.argtypes = [vp] * 6 + [ci] * 3 + [vp]
    lib.dense_input_grad.restype = ci
    lib.dense_wpack_floats.argtypes = [ci, ci]
    lib.dense_wpack_floats.restype = ctypes.c_longlong
    return lib


def build():
    """Build ``csrc/linear.cu`` (``ops/build.py``) and load it."""
    return _lib()


def _check(what, x, weight, others):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: CUDA tensors only, got {x.device}")
    if weight.dim() != 2:
        raise ValueError(f"{what}: weight must be 2-D, got "
                         f"{tuple(weight.shape)}")
    for name, t in (("input", x), ("weight", weight)) + others:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {x.device} and "
                             f"{t.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {tuple(x.shape)} has 2^31 entries or more")


def _like(what, name, t, shape):
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return None if t is None else t.detach().contiguous()


def _raise_on(what, err):
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{what}: the kernel refused the shape "
                         f"(cudaErrorInvalidValue: csrc/linear.cu takes an "
                         f"inner size that is a multiple of 32 and an output "
                         f"width that is a multiple of 128)")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def a_layout(x):
    """``x [..., K]`` as the kernel reads it: ``(x, 0)`` where it is
    contiguous; ``(x3, V)`` where ``x`` is ``[V, ..., K]`` over a ``[V, K,
    P]`` tensor whose last dimension is contiguous (lin_z's latent taps),
    ``x3`` the ``[V, P, K]`` view, P a multiple of 4; else a contiguous
    copy."""
    if x.is_contiguous():
        return x, 0
    if x.dim() >= 3:
        k = x.shape[-1]
        x3 = x.flatten(1, -2)
        v, p = x3.shape[:2]
        if x3.stride() == (k * p, 1, p) and p % 4 == 0:
            return x3, v
    return x.contiguous(), 0


def dense_forward(x, weight, bias, addend, relu):
    """The kernel's forward: ``dense_plain`` on CUDA float32 tensors
    (counted in ``dense_forward.launches``)."""
    what = "dense_forward"
    _check(what, x, weight, (("bias", bias), ("addend", addend)))
    n, k = weight.shape
    if x.shape[-1] != k:
        raise ValueError(f"{what}: weight {tuple(weight.shape)} for inputs "
                         f"of {x.shape[-1]}")
    lead = tuple(x.shape[:-1])
    bias = _like(what, "bias", bias, (n,))
    addend = _like(what, "addend", addend, lead + (n,))
    a, views = a_layout(x)
    weight = weight.detach().contiguous()
    out = torch.empty(lead + (n,), dtype=x.dtype, device=x.device)
    lib = _lib()
    wpack = torch.empty(lib.dense_wpack_floats(n, k), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dense_forward(
            a.data_ptr(), weight.data_ptr(), _ptr(bias), _ptr(addend),
            out.data_ptr(), wpack.data_ptr(), x.numel() // k, n, k, views,
            int(relu), _stream(x.device))
    _raise_on(what, err)
    dense_forward.launches += 1
    return out


dense_forward.launches = 0


def dense_input_grad(grad, weight, mask, addend):
    """The kernel's input gradient: ``dense_input_grad_plain`` on CUDA
    float32 tensors (counted in ``dense_input_grad.launches``)."""
    what = "dense_input_grad"
    _check(what, grad, weight, (("mask", mask), ("addend", addend)))
    n, k = weight.shape
    if grad.shape[-1] != n:
        raise ValueError(f"{what}: weight {tuple(weight.shape)} for a "
                         f"gradient of {grad.shape[-1]}")
    lead = tuple(grad.shape[:-1])
    mask = _like(what, "mask", mask, lead + (k,))
    addend = _like(what, "addend", addend, lead + (k,))
    grad = grad.contiguous()
    weight = weight.detach().contiguous()
    out = torch.empty(lead + (k,), dtype=grad.dtype, device=grad.device)
    lib = _lib()
    wpack = torch.empty(lib.dense_wpack_floats(k, n), dtype=torch.float32,
                        device=grad.device)
    with torch.cuda.device(grad.device):
        err = lib.dense_input_grad(
            grad.data_ptr(), weight.data_ptr(), _ptr(mask), _ptr(addend),
            out.data_ptr(), wpack.data_ptr(), grad.numel() // n, n, k,
            _stream(grad.device))
    _raise_on(what, err)
    dense_input_grad.launches += 1
    return out


dense_input_grad.launches = 0


# the operators: plain versions on the CPU, the kernel on a card (each
# looked up when called, so that a test can stand in for it), beside
# ``ops/conv2d.py``'s in the same namespace
_OPS = torch.library.Library("nerfool_torch", "FRAGMENT")
_OPS.define("dense(Tensor x, Tensor weight, Tensor? bias, Tensor? addend, "
            "bool relu) -> Tensor")
_OPS.define("dense_input_grad(Tensor grad, Tensor weight, Tensor? mask, "
            "Tensor? addend) -> Tensor")
_OPS.impl("dense", lambda *a: dense_plain(*a), "CPU")
_OPS.impl("dense", lambda *a: dense_forward(*a), "CUDA")
_OPS.impl("dense_input_grad", lambda *a: dense_input_grad_plain(*a), "CPU")
_OPS.impl("dense_input_grad", lambda *a: dense_input_grad(*a), "CUDA")


def _weight_grads(grad, x, relu, need_w, need_b):
    """``F.linear``'s weight and bias gradients for input ``x`` (after its
    ReLU where ``relu``), where asked."""
    g2 = grad.reshape(-1, grad.shape[-1])
    gw = gb = None
    if need_w:
        a = F.relu(x) if relu else x
        gw = g2.t().matmul(a.reshape(-1, a.shape[-1]))
    if need_b:
        gb = g2.sum(0)
    return gw, gb


class ResidualBlock(torch.autograd.Function):
    """``u + fc_1(relu(fc_0(relu(u))))`` with ``u = h + lin_z(taps)``, or
    ``u = h`` where ``taps`` is None, through the two operators."""

    @staticmethod
    def forward(ctx, h, taps, wz, bz, w0, b0, w1, b1):
        dense = torch.ops.nerfool_torch.dense
        u = h if taps is None else dense(taps, wz, bz, h, False)
        f0 = dense(u, w0, b0, None, True)
        ctx.save_for_backward(taps, u, f0, wz, w0, w1)
        return dense(f0, w1, b1, u, True)

    @staticmethod
    def backward(ctx, grad):
        taps, u, f0, wz, w0, w1 = ctx.saved_tensors
        grad = grad.contiguous()  # the views' mean hands block 2 a broadcast
        input_grad = torch.ops.nerfool_torch.dense_input_grad
        need = ctx.needs_input_grad  # h, taps, wz, bz, w0, b0, w1, b1
        gw1, gb1 = _weight_grads(grad, f0, True, need[6], need[7])
        if not any(need[:6]):
            return None, None, None, None, None, None, gw1, gb1
        df0 = input_grad(grad, w1, f0, None)
        du = input_grad(df0, w0, u, grad)
        gw0, gb0 = _weight_grads(df0, u, True, need[4], need[5])
        gtaps = input_grad(du, wz, None, None) if need[1] else None
        gwz, gbz = (None, None) if taps is None else _weight_grads(
            du, taps, False, need[2], need[3])
        return du, gtaps, gwz, gbz, gw0, gb0, gw1, gb1


def resnet_block(h, fc_0, fc_1, lin_z=None, taps=None):
    """``ResnetBlockFC`` (``fc_0``, ``fc_1``: its ``nn.Linear`` layers) on
    ``h + lin_z(taps)``, or on ``h`` without ``lin_z``: the kernel for CUDA
    tensors, the plain versions for CPU ones, differentiable in every
    tensor argument."""
    wz, bz = (None, None) if lin_z is None else (lin_z.weight, lin_z.bias)
    return ResidualBlock.apply(h, taps, wz, bz, fc_0.weight, fc_0.bias,
                               fc_1.weight, fc_1.bias)


def takes(x):
    """Whether ``ResnetFC``'s blocks on ``x`` go through ``resnet_block``
    (the kernel or its plain version) rather than the module's layers."""
    if x.device.type == "cuda":
        return x.dtype == torch.float32
    return x.device.type == "cpu" and x.dtype in (torch.float32,
                                                  torch.float64)
