"""The BSPG selection wrapper (``ops/bspg_select.py``) and its CUDA kernel.

This file imports no JAX, so it also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU the plain version is held to the selection contract written as
loops (float64): 1e-5 relative / 1e-6 absolute at float32. The CUDA-marked
tests skip without a card.
"""
import numpy as np
import pytest
import torch

from nerfool_tpu_torch.ops import bspg_select


def _taps_inputs(rng, n_rv=6, ks=21, ns=40, p=4, c=3, dtype=torch.float32,
                 device="cpu"):
    """Random selection operands: slot lists with -1 pads and a repeated id
    (the contract sums every matching slot), pids drawn from the slots."""
    slots = rng.randint(0, 60, (n_rv, ks)).astype(np.int32)
    slots[:, -3:] = -1
    slots[:, 1] = slots[:, 0]
    pid = np.take_along_axis(slots, rng.randint(0, ks - 3, (n_rv, ns)), 1)
    pid[:, :2] = 61  # matches no slot
    f = lambda *s: torch.as_tensor(rng.rand(*s).astype(np.float32),
                                   device=device)
    i = lambda x: torch.as_tensor(x.astype(np.int32), device=device)
    g = f(n_rv, ks, (p + 1) ** 2 * c).to(dtype)
    return (g, i(slots), i(pid), i(rng.randint(0, p, (n_rv, ns))),
            i(rng.randint(0, p, (n_rv, ns))), f(n_rv, ns), f(n_rv, ns),
            f(n_rv, ns), f(n_rv, ns), p, c)


def _taps_loop(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1, p, c):
    """The contract written as loops (numpy, float64)."""
    g = g.double().numpy().reshape(g.shape[0], g.shape[1], p + 1, p + 1, c)
    n_rv, ns = pid.shape
    out = np.zeros((n_rv, ns, c))
    for r in range(n_rv):
        for s in range(ns):
            y, x = int(ly[r, s]), int(lx[r, s])
            for k in np.nonzero(slots[r].numpy() == int(pid[r, s]))[0]:
                for dy, wy in ((0, wy0[r, s]), (1, wy1[r, s])):
                    for dx, wx in ((0, wx0[r, s]), (1, wx1[r, s])):
                        out[r, s] += float(wy * wx) * g[r, k, y + dy, x + dx]
    return out


@pytest.mark.parametrize("c", [3, 32])
def test_plain_selection_matches_contract(c):
    """The plain version sums every matching slot; unmatched pids give 0."""
    args = _taps_inputs(np.random.RandomState(c), c=c)
    before = bspg_select.select_taps.launches
    out = bspg_select.select_taps(*args)
    assert bspg_select.select_taps.launches == before  # CPU: no launch
    np.testing.assert_allclose(out.numpy(), _taps_loop(*args), rtol=1e-5,
                               atol=1e-6)
    assert not out[:, :2].any()


def test_select_taps_rejects_bad_inputs():
    args = list(_taps_inputs(np.random.RandomState(0)))
    with pytest.raises(ValueError, match="dtype"):
        bspg_select.select_taps(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="int32"):
        bspg_select.select_taps(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError, match="row"):
        bspg_select.select_taps(*args[:-2], args[-2] + 1, args[-1])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="device"):
        bspg_select.select_taps(*meta)


# ---- on the card: the CUDA kernel against its plain version ----

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(c, dtype):
    """f32 tables: the sums differ in order only, a few f32 ulps of the
    output (outputs reach ~4 here, where an ulp is 4.8e-7): 2e-6 relative
    plus 1e-6 absolute. bf16 tables: both sides
    accumulate in f32 and round once to bf16, so they differ by at most one
    bf16 ulp of the output, 2^-7 relative."""
    _require_cuda()
    args = _taps_inputs(np.random.RandomState(c), n_rv=64, ks=120, ns=2048,
                        p=12, c=c, dtype=dtype, device="cuda")
    before = bspg_select.select_taps.launches
    out = bspg_select.select_taps(*args)
    torch.cuda.synchronize()
    assert bspg_select.select_taps.launches == before + 1
    ref = bspg_select.select_taps_plain(*args).float()
    out = out.float()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=2e-6, atol=1e-6)
    else:
        tol = 2.0 ** -7 * torch.maximum(out.abs(), ref.abs()) + 1e-6
        assert bool(((out - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_kernel_raises_on_bad_layout():
    _require_cuda()
    args = list(_taps_inputs(np.random.RandomState(0), device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        bspg_select.select_taps(args[0].transpose(0, 1).contiguous()
                                .transpose(0, 1), *args[1:])
