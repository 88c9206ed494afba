"""The kernel wrappers and their CUDA kernels: BSPG selection
(``ops/bspg_select.py``), the whole GNT chain (``ops/chain.py``), the ray
attention, forward and backward (``ops/ray_attention.py``), and the view
attention (``ops/view_attention.py``); and the depth warp's z-buffer
(``attack/warp.py``), a scatter-min whose atomics run on the card.

This file imports no JAX, so it also runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On the CPU the plain selection is held to its contract written as loops
(float64): 1e-5 relative / 1e-6 absolute at float32; the chain wrapper's CPU
path and input checks are tested here, its parity with JAX in
test_torch_gnt. The CUDA-marked tests (kernel against plain version) skip
without a card.
"""
import copy

import numpy as np
import pytest
import torch

from nerfool_tpu_torch.attack import warp
from nerfool_tpu_torch.models.bundle import create_model
from nerfool_tpu_torch.ops import bspg_select, chain, ray_attention as ra
from nerfool_tpu_torch.ops import view_attention as va

# the test tier runs several worker processes on a few cores: two math
# threads per process instead of one per core keeps them from thrashing
torch.set_num_threads(2)


# views of the selection group and the neighbouring channels of the buffer
# the taps are written into: everything else must keep the sentinel
GROUP, OFFSET, SPARE, SENTINEL = (0, 2), 2, 5, 7.0


def _taps_inputs(rng, v=3, b=4, n=4, s=10, p=4, h=11, w=13, c=3, ks=21,
                 dtype=torch.float32, device="cpu"):
    """Random selection operands: a patch table of V views, the slot lists
    of the views in GROUP with -1 pads and a repeated id (the contract sums
    every matching slot), coordinates of which half fall in a slot's patch,
    some past the image's edge (zeros padding), the rest anywhere, many in
    no slot's patch; a [V, B*n, S, c + SPARE] buffer of SENTINEL."""
    pby, pbx = -(-(h + 1) // p), -(-(w + 1) // p)
    table = rng.rand(v, pby * pbx, (p + 1) ** 2 * c).astype(np.float32)
    slots = rng.randint(0, pby * pbx, (len(GROUP), b, ks)).astype(np.int32)
    slots[..., 1] = slots[..., 0]
    slots[..., -3:] = -1
    # base cell cb of a coordinate x is floor(x) + 1 (clipped): a patch q
    # holds cells [q p, q p + p)
    pick = np.take_along_axis(np.broadcast_to(slots[:, :, None], (
        len(GROUP), b, n * s, ks)), rng.randint(0, ks - 3, (
            len(GROUP), b, n * s, 1)), -1)[..., 0]
    cell = lambda q, lim: np.minimum(q * p + rng.randint(0, p, q.shape), lim)
    xs = cell(pick % pbx, w) - 1 + rng.rand(*pick.shape)
    ys = cell(pick // pbx, h) - 1 + rng.rand(*pick.shape)
    gx = rng.uniform(-1.15, 1.15, (v, b, n * s))
    gy = rng.uniform(-1.15, 1.15, (v, b, n * s))
    half = rng.rand(len(GROUP), b, n * s) < 0.5
    for i, view in enumerate(GROUP):
        gx[view] = np.where(half[i], 2.0 * xs[i] / (w - 1) - 1.0, gx[view])
        gy[view] = np.where(half[i], 2.0 * ys[i] / (h - 1) - 1.0, gy[view])
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    out = torch.full((v, b * n, s, c + SPARE), SENTINEL, dtype=dtype,
                     device=device)
    return dict(table=f(table).to(dtype),
                slots=torch.as_tensor(slots, device=device), views=GROUP,
                gx=f(gx.reshape(v, b, n, s)), gy=f(gy.reshape(v, b, n, s)),
                out=out, offset=OFFSET, p=p, h=h, w=w, pbx=pbx)


def _select(a, **over):
    a = dict(a, **over)
    return bspg_select.select_taps(a["table"], a["slots"], a["views"],
                                   a["gx"], a["gy"], a["out"], a["offset"],
                                   a["p"], a["h"], a["w"], a["pbx"])


def _taps_loop(a):
    """The contract as m(rv, s) x the bilinear tap of table row pid (numpy,
    the coordinates' float32 ingredients, sums in float64): [Vg, B, ns, c]."""
    table = a["table"].double().cpu().numpy()
    p, h, w, pbx = a["p"], a["h"], a["w"], a["pbx"]
    c = table.shape[-1] // (p + 1) ** 2
    table = table.reshape(table.shape[0], -1, p + 1, p + 1, c)
    slots = a["slots"].cpu().numpy()
    vg, b, _ = slots.shape
    out = np.zeros((vg, b, a["gx"][0, 0].numel(), c))
    one, half = np.float32(1), np.float32(0.5)
    for i, view in enumerate(a["views"]):
        gx = a["gx"][view].reshape(b, -1).cpu().numpy()
        gy = a["gy"][view].reshape(b, -1).cpu().numpy()
        for blk in range(b):
            for s in range(gx.shape[1]):
                ix = (gx[blk, s] + one) * half * np.float32(w - 1)
                iy = (gy[blk, s] + one) * half * np.float32(h - 1)
                x0, y0 = np.floor(ix), np.floor(iy)
                cbx = int(min(max(x0, -1), w - 1)) + 1
                cby = int(min(max(y0, -1), h - 1)) + 1
                pid = (cby // p) * pbx + cbx // p
                m = int((slots[i, blk] == pid).sum())
                ly, lx = cby % p, cbx % p
                for dy, wy in ((0, one - (iy - y0)), (1, iy - y0)):
                    for dx, wx in ((0, one - (ix - x0)), (1, ix - x0)):
                        if 0 <= y0 + dy <= h - 1 and 0 <= x0 + dx <= w - 1:
                            out[i, blk, s] += m * float(wy) * float(wx) * \
                                table[view, pid, ly + dy, lx + dx]
    return out


def _check_written(a, res, ref, rtol, atol):
    """``res`` holds ``ref`` at the group's views and channels [OFFSET,
    OFFSET + c); every other entry of the buffer keeps SENTINEL."""
    v, b, n, s = a["gx"].shape
    c = ref.shape[-1]
    got = res.float().cpu().reshape(v, b, n * s, -1).numpy()
    vi = list(a["views"])
    for i, view in enumerate(vi):
        np.testing.assert_allclose(got[view, ..., OFFSET:OFFSET + c], ref[i],
                                   rtol=rtol, atol=atol)
    keep = np.ones(got.shape, bool)
    keep[vi, ..., OFFSET:OFFSET + c] = False
    assert (got[keep] == SENTINEL).all()


@pytest.mark.parametrize("c", [3, 32])
def test_plain_selection_matches_contract(c):
    """The plain version (gathered rows, one-hot einsum) equals m(rv, s) x
    the bilinear tap of the table row: repeated slots count twice, pads and
    pids in no slot give 0, corners off the image read as zeros; it writes
    only its views and channels of the buffer."""
    a = _taps_inputs(np.random.RandomState(c), c=c)
    before = bspg_select.select_taps.launches
    res = _select(a)
    assert bspg_select.select_taps.launches == before  # CPU: no launch
    assert res is a["out"]
    ref = _taps_loop(a)
    _check_written(a, res, ref, 1e-5, 1e-6)
    slots = a["slots"].numpy()
    assert (ref != 0).any() and (ref == 0).all(-1).any()
    assert (slots[..., 1] == slots[..., 0]).all() and (slots < 0).any()


def test_select_taps_rejects_bad_inputs():
    a = _taps_inputs(np.random.RandomState(0))
    with pytest.raises(ValueError, match="dtype"):
        _select(a, table=a["table"].double())
    with pytest.raises(ValueError, match="int32"):
        _select(a, slots=a["slots"].long())
    with pytest.raises(ValueError, match="row"):
        _select(a, p=a["p"] + 1)
    with pytest.raises(ValueError, match="channels"):
        _select(a, offset=SPARE + 1)
    with pytest.raises(ValueError, match="out must be"):
        _select(a, out=a["out"][:, :-1])
    with pytest.raises(ValueError, match="views"):
        _select(a, views=(0, 3))
    meta = {k: t.to("meta") if isinstance(t, torch.Tensor) else t
            for k, t in a.items()}
    with pytest.raises(ValueError, match="device"):
        _select(meta)


# ---- on the card: the CUDA kernel against its plain version ----

def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(c, dtype):
    """The kernel against the plain version on the same buffer layout (its
    neighbouring channels and other views untouched). f32 tables: the sums
    differ in order only, a few f32 ulps of the output (outputs reach ~4
    here, where an ulp is 4.8e-7): 2e-6 relative plus 1e-6 absolute. bf16
    tables: both sides accumulate in f32 and round once to bf16, so they
    differ by at most one bf16 ulp of the output, 2^-7 relative."""
    _require_cuda()
    a = _taps_inputs(np.random.RandomState(c), v=4, b=64, n=16, s=128, p=12,
                     h=95, w=126, c=c, ks=120, dtype=dtype, device="cuda")
    before = bspg_select.select_taps.launches
    out = _select(a)
    torch.cuda.synchronize()
    assert bspg_select.select_taps.launches == before + 1
    cpu = {k: t.cpu() if isinstance(t, torch.Tensor) else t
           for k, t in a.items()}
    cpu["out"] = torch.full_like(cpu["out"], SENTINEL)
    ref = _select(cpu).float()
    v, b, n, s = a["gx"].shape
    ref = ref.reshape(v, b, n * s, -1)[list(GROUP), ..., OFFSET:OFFSET + c]
    if dtype == torch.float32:
        _check_written(a, out, ref.numpy(), 2e-6, 1e-6)
    else:
        got = out.float().cpu().reshape(v, b, n * s, -1)[
            list(GROUP), ..., OFFSET:OFFSET + c]
        tol = 2.0 ** -7 * torch.maximum(got.abs(), ref.abs()) + 1e-6
        assert bool(((got - ref).abs() <= tol).all())
        _check_written(a, out, got.numpy(), 0, 0)


@pytest.mark.cuda
def test_kernel_raises_on_bad_layout():
    _require_cuda()
    a = _taps_inputs(np.random.RandomState(0), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        _select(a, table=a["table"].transpose(0, 1).contiguous()
                .transpose(0, 1))


# ---- the whole-chain GNT aggregation (ops/chain.py, csrc/gnt_chain.cu) ----

def _chain_case(depth=2, v=4, r=6, s=24, seed=0, device="cpu",
                masked_ray=False):
    """A seeded GNT net and chain operands (rgb_feat ~ N(0, 1), ray_diff with
    its dot in [-1, 1], ~20% of the views masked; ``masked_ray``: every view
    of ray 0 masked)."""
    net = create_model(backbone="gnt", trans_depth=depth, seed=seed,
                       device=device).net_coarse
    rng = np.random.RandomState(seed)
    f = lambda x: torch.as_tensor(x.astype(np.float32), device=device)
    rd = rng.randn(v, r, s, 4)
    rd[..., 3] = np.tanh(rd[..., 3])
    mask = (rng.rand(v, r, s, 1) > 0.2).astype(np.float32)
    if masked_ray:
        mask[:, 0] = 0.0
    merged, emb = chain.chain_inputs(
        net, f(rng.randn(v, r, s, 35)), f(rd), f(mask), f(rng.randn(r, s, 3)),
        f(rng.randn(r, 3)))
    return net, merged, emb


def _rounded(net, dtype):
    """A copy of ``net`` whose weights hold exactly their ``dtype`` values
    (in float32): the f32 reference on the weights a ``dtype`` run uses."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(dtype).float())
    return out


def test_chain_plain_on_cpu_launches_nothing():
    net, merged, emb = _chain_case(depth=3, r=5, s=13)
    before = chain.gnt_chain.launches
    q, attn0 = chain.gnt_chain(net, merged, emb)
    assert chain.gnt_chain.launches == before
    assert q.shape == (5, 13, 64) and attn0.shape == (5, 13)
    # the plain version is the module's own chain
    rq, ra = net.chain(merged[..., :35], merged[..., 35:39], merged[..., 39:],
                       emb[..., :63], emb[..., 63:])
    torch.testing.assert_close(q, rq, rtol=0, atol=0)
    torch.testing.assert_close(attn0, ra, rtol=0, atol=0)
    # attn0 is a head-mean softmax row: each ray's weights sum to 1
    torch.testing.assert_close(attn0.sum(-1), torch.ones(5), rtol=0,
                               atol=1e-5)


def test_stack_weights_follow_weight_updates():
    """The kernel's weight blobs are stacked once per net, dtype and weight
    version: reused while the weights stand, made anew after
    ``load_state_dict`` or an in-place update. f32: three f32 blobs. bf16:
    packed bf16 matrices and f32 vectors that hold bf16 values, both within
    a bf16 rounding of the f32 weights."""
    net = create_model(backbone="gnt", trans_depth=3, seed=0).net_coarse
    w = chain.stack_weights(net, torch.float32)
    assert chain.stack_weights(net, torch.float32) is w  # stacked once
    assert len(w) == 3 and all(a.dtype == torch.float32 for a in w)
    wb = chain.stack_weights(net, torch.bfloat16)
    assert chain.stack_weights(net, torch.bfloat16) is wb
    assert [b.dtype for b in wb] == [torch.bfloat16, torch.float32] * 3
    for b in wb[1::2]:  # the vectors hold bf16 values
        torch.testing.assert_close(b, b.bfloat16().float(), rtol=0, atol=0)
    f32, bf = (chain.chain_matrices(net, dt)
               for dt in (torch.float32, torch.bfloat16))
    for name in f32:
        a, b = f32[name], bf[name]
        assert a.shape == b.shape and b.dtype == torch.float32
        torch.testing.assert_close(b, b.bfloat16().float(), rtol=0, atol=0)
        assert float((a - b).abs().max()) <= 2.0 ** -7 * float(a.abs().max())
    other = create_model(backbone="gnt", trans_depth=3, seed=1).net_coarse
    net.load_state_dict(other.state_dict())
    w2 = chain.stack_weights(net, torch.float32)
    assert w2 is not w
    for a, b in zip(w2, chain.stack_weights(other, torch.float32)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        net.rgb_fc.bias.add_(1.0)
    assert chain.stack_weights(net, torch.float32) is not w2
    assert chain.stack_weights(net, torch.bfloat16) is not wb


# the bf16 kernel's per-depth matrices: name -> (K, N) of the product, in
# the order of the blob (csrc/gnt_chain.cu, tc::M_*); vt_p1 carries its bias
# as a ninth row
_TC_MATRICES = (("vt_wq", 64, 64), ("vt_wkv", 64, 128), ("vt_p0", 4, 8),
                ("vt_p1", 9, 64), ("vt_a0", 64, 8), ("vt_a1", 8, 64),
                ("vt_wo", 64, 64), ("vt_f1", 64, 256), ("vt_f2", 256, 64),
                ("ra_wq", 64, 64), ("ra_wkv", 64, 128), ("ra_wo", 64, 64),
                ("ra_f1", 64, 256), ("ra_f2", 256, 64))


def _fragment_product(a, packed, k, n):
    """``a @ W`` as the kernel forms it: for every 16 x 8 fragment each lane
    ``4 g + t`` multiplies the A elements of its rows by the four packed
    values it loads, (k, n) = (16 kt + 2 t + (e & 1) + 8 (e >> 1),
    8 nt + g); f32 accumulation over bf16 values."""
    k16 = -(-k // 16) * 16
    a16 = np.zeros((a.shape[0], k16), np.float32)
    a16[:, :k] = a
    w = packed.float().numpy().reshape(k16 // 16, n // 8, 32, 4)
    out = np.zeros((a.shape[0], n), np.float32)
    for kt in range(k16 // 16):
        for nt in range(n // 8):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    kk = 16 * kt + 2 * t + (e & 1) + 8 * (e >> 1)
                    out[:, 8 * nt + g] += a16[:, kk] * w[kt, nt, lane, e]
    return out


def _bf16(x):
    return torch.as_tensor(x).bfloat16().float().numpy()


@pytest.mark.parametrize("group", ["layers", "qfc", "entry"])
def test_packed_bf16_weights_reproduce_products(group):
    """Reading the packed bf16 blobs back through the kernel's fragment
    indexing reproduces ``A @ W`` for every matrix of a depth-3 net, with
    bf16-valued operands and f32 sums: [Wk | Wk Wv], the ray attention's
    q and k | v split (head h in columns 16 h ...), the pos MLP's second
    matrix with its bias as row 8 (the kernel's hidden layer has a one in
    column 8), the zero rows that pad q_fc's two 63-wide embeddings to 64
    and the entry's 35 inputs to 48."""
    net = create_model(backbone="gnt", trans_depth=3, seed=3).net_coarse
    f = chain.chain_matrices(net, torch.bfloat16)
    f["vt_p1"] = torch.cat([f["vt_p1"], f["vt_p1b"][:, None]], dim=1)
    entry_m, entry_v, layer_m, layer_v, qfc_m, qfc_v = chain.stack_weights(
        net, torch.bfloat16)
    rng = np.random.RandomState(0)

    def check(packed, w, k, n):
        a = _bf16(rng.randn(5, k).astype(np.float32))
        ref = a.astype(np.float64) @ w.double().numpy()
        got = _fragment_product(a, packed, k, n)
        # both sum exact products of bf16 values; f32 sums of <= 256 terms
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
        torch.testing.assert_close(chain.unpack_b(packed.float(), k, n), w,
                                   rtol=0, atol=0)

    if group == "layers":
        per = layer_m.reshape(3, -1)
        assert per.shape[1] == sum(-(-k // 16) * 16 * n
                                   for _, k, n in _TC_MATRICES)
        for i in range(3):
            off = 0
            for name, k, n in _TC_MATRICES:
                size = -(-k // 16) * 16 * n
                assert f[name][i].shape == (k, n)
                check(per[i, off:off + size], f[name][i], k, n)
                off += size
        # [Wk | Wk Wv]: the right half is the rounded product of the
        # rounded factors
        attn = net.view_crosstrans[1].attn
        wk = attn.k_fc.weight.t().bfloat16().float()
        wv = attn.v_fc.weight.t().bfloat16().float()
        torch.testing.assert_close(f["vt_wkv"][1][:, 64:],
                                   (wk @ wv).bfloat16().float(), rtol=0,
                                   atol=0)
        # ray attention: q, then k | v, heads in the module's column order
        ra_ = net.view_selftrans[2].attn
        torch.testing.assert_close(
            torch.cat([f["ra_wq"][2], f["ra_wkv"][2]], dim=1),
            torch.cat([ra_.q_fc.weight, ra_.k_fc.weight, ra_.v_fc.weight])
            .t().bfloat16().float(), rtol=0, atol=0)
        # p = [relu(.) | 1] @ [P1; b]: the bias row gives the biased product
        ph = _bf16(rng.rand(5, 8).astype(np.float32))
        size = 16 * 64
        off = sum(-(-k // 16) * 16 * n for _, k, n in _TC_MATRICES[:3])
        got = _fragment_product(np.concatenate([ph, np.ones((5, 1), "f4")], 1),
                                per[0, off:off + size], 9, 64)
        raw = chain.chain_matrices(net, torch.bfloat16)
        want = ph @ raw["vt_p1"][0].numpy() + raw["vt_p1b"][0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # the vectors: no vt_p1b (in the matrix) and no vt_a1b (the softmax
        # over the views does not see it)
        vec = layer_v.reshape(3, -1)
        assert vec.shape[1] == 4 * 128 + 2 * 8 + 4 * 64 + 2 * 256
        torch.testing.assert_close(
            vec[2, -64:],
            net.view_selftrans[2].ff.fc2.bias.detach().bfloat16().float(),
            rtol=0, atol=0)
    elif group == "qfc":
        per = qfc_m.reshape(2, -1)  # depths 0 and 2
        for j, i in enumerate((0, 2)):
            check(per[j, :192 * 64], f["qf_w0"][j], 192, 64)
            check(per[j, 192 * 64:], f["qf_w1"][j], 64, 64)
            w0 = net.q_fcs[i][0].weight.t().detach().bfloat16().float()
            got = chain.unpack_b(per[j, :192 * 64].float(), 192, 64)
            torch.testing.assert_close(got[:64], w0[:64], rtol=0, atol=0)
            torch.testing.assert_close(got[64:127], w0[64:127], rtol=0, atol=0)
            torch.testing.assert_close(got[128:191], w0[127:], rtol=0, atol=0)
            assert not got[127].any() and not got[191].any()
        assert qfc_v.numel() == 2 * 128
    else:
        assert entry_m.numel() == 48 * 64 + 64 * 64 and entry_v.numel() == 128
        check(entry_m[:48 * 64], f["e0"], 35, 64)
        got = chain.unpack_b(entry_m[:48 * 64].float(), 48, 64)
        assert not got[35:].any()
        check(entry_m[48 * 64:], f["e1"], 64, 64)


def _chain_rounded_like_kernel(net, merged, emb):
    """The chain in plain PyTorch with the bf16 kernel's rounding points:
    every product takes bf16-valued operands (x, LayerNorm outputs, the
    hidden layers, qp, kp - qp + p, the softmax-weighted o, the attention
    probabilities, K and V) and sums in f32; the residual stream q, the
    LayerNorm statistics, both softmaxes, v + p and every bias stay in f32;
    the outputs are rounded once."""
    f = chain.chain_matrices(net, torch.bfloat16)
    r = lambda x: x.bfloat16().float()
    merged, emb = merged.float(), emb.float()
    rf, rd, mask = merged[..., :35], merged[..., 35:39], merged[..., 39:]

    def ln(x, gb):
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        return r((x - m) / torch.sqrt(v + 1e-6) * gb[0] + gb[1])

    def ff(q, i, p):
        h = r(torch.relu(ln(q, f[p + "_ln2"][i]) @ f[p + "_f1"][i]
                         + f[p + "_f1b"][i]))
        return q + h @ f[p + "_f2"][i] + f[p + "_f2b"][i]

    x = r(r(torch.relu(rf @ f["e0"] + f["e0b"])) @ f["e1"] + f["e1b"])
    q = x.max(dim=0).values
    attn0 = None
    for i in range(net.trans_depth):
        qp = r(ln(q, f["vt_ln1"][i]) @ f["vt_wq"][i])
        kv = x @ f["vt_wkv"][i]
        ph = r(torch.relu(rd @ f["vt_p0"][i] + f["vt_p0b"][i]))
        p = ph @ f["vt_p1"][i] + f["vt_p1b"][i]
        hb = r(torch.relu(r(kv[..., :64] + p - qp) @ f["vt_a0"][i]
                          + f["vt_a0b"][i]))
        a = hb @ f["vt_a1"][i] + f["vt_a1b"][i]
        a = a.masked_fill(mask == 0, -1e9)
        w = torch.softmax(a, dim=0)
        o = r(((kv[..., 64:] + p) * w).sum(0))
        q = q + o @ f["vt_wo"][i] + f["vt_wob"][i]
        q = ff(q, i, "vt")
        if i % 2 == 0:
            j = i // 2
            cat = torch.cat([r(q), emb[..., :63], emb[..., 63:]], dim=-1)
            w0 = f["qf_w0"][j]
            w0 = torch.cat([w0[:127], w0[128:191]])
            h = r(torch.relu(cat @ w0 + f["qf_b0"][j]))
            q = h @ f["qf_w1"][j] + f["qf_b1"][j]
        y = ln(q, f["ra_ln1"][i])
        n_r, n_s, _ = y.shape
        qh = r(y @ f["ra_wq"][i] * 0.25).reshape(n_r, n_s, 4, 16)
        kvh = r(y @ f["ra_wkv"][i])
        kh = kvh[..., :64].reshape(n_r, n_s, 4, 16)
        vh = kvh[..., 64:].reshape(n_r, n_s, 4, 16)
        sc = torch.einsum("rqhc,rkhc->rhqk", qh, kh)
        pr = torch.softmax(sc, dim=-1)
        attn0 = pr[:, :, 0].mean(1)
        # the kernel rounds the unnormalised probabilities and divides the
        # f32 sum afterwards
        e = torch.exp(sc - sc.max(-1, keepdim=True).values)
        out = torch.einsum("rhqk,rkhc->rqhc", r(e), vh) / e.sum(-1).permute(
            0, 2, 1)[..., None]
        q = q + r(out.reshape(n_r, n_s, 64)) @ f["ra_wo"][i] + f["ra_wob"][i]
        q = ff(q, i, "ra")
    return r(q), r(attn0)


@pytest.mark.parametrize("depth", [2, 8])
def test_chain_bf16_rounding_points_within_plain_error(depth):
    """The bf16 kernel's rounding points, emulated in plain PyTorch on the
    CPU, against the f32 chain on the same bf16 inputs and bf16-valued
    weights: the error in q and in attn0 is no larger than the plain bf16
    chain's own (which also rounds every sum, residual and softmax), so the
    on-card bound of 1.0 x the plain chain's error is reachable."""
    net, merged, emb = _chain_case(depth=depth, v=4, r=6, s=24, seed=depth,
                                   masked_ray=True)
    mb, eb = merged.bfloat16(), emb.bfloat16()
    with torch.no_grad():
        ref = chain.gnt_chain_plain(_rounded(net, torch.bfloat16), mb.float(),
                                    eb.float())
        plain = chain.gnt_chain_plain(net, mb, eb)
        got = _chain_rounded_like_kernel(net, mb, eb)
    for k in range(2):
        assert bool(torch.isfinite(got[k]).all())
        err_k = float((got[k] - ref[k]).abs().max())
        err_p = float((plain[k].float() - ref[k]).abs().max())
        assert err_k <= err_p, (k, err_k, err_p)


def test_chain_rejects_bad_inputs():
    net, merged, emb = _chain_case()
    with pytest.raises(ValueError, match="dtype"):
        chain.gnt_chain(net, merged.double(), emb.double())
    with pytest.raises(ValueError, match="dtype"):
        chain.gnt_chain(net, merged.bfloat16(), emb)
    with pytest.raises(ValueError, match="emb"):
        chain.gnt_chain(net, merged, emb[:, :-1])
    with pytest.raises(ValueError, match="channels"):
        chain.gnt_chain(net, merged[..., 1:], emb)
    with pytest.raises(ValueError, match="devices"):
        chain.gnt_chain(net, merged.to("meta"), emb.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,r,s,masked", [(2, 6, 24, False),
                                              (3, 5, 13, True),
                                              (8, 40, 192, False)])
def test_chain_kernel_matches_plain_f32(depth, r, s, masked):
    """f32: kernel and plain differ in summation order only (~1e-6 of the
    output per product); the LayerNorms of every block re-normalise, so the
    difference stays near that. Held to 1e-4 of the output scale. Covers R
    not a multiple of anything, S not a multiple of the 8-sample tile, and a
    ray with every view masked (uniform view weights, finite)."""
    _require_cuda()
    net, merged, emb = _chain_case(depth=depth, v=10 if depth == 8 else 4,
                                   r=r, s=s, device="cuda", masked_ray=masked)
    before = chain.gnt_chain.launches
    with torch.no_grad():
        q, attn0 = chain.gnt_chain(net, merged, emb)
        torch.cuda.synchronize()
        assert chain.gnt_chain.launches == before + 1
        rq, ra = chain.gnt_chain_plain(net, merged, emb)
    assert bool(torch.isfinite(q).all()) and bool(torch.isfinite(attn0).all())
    for got, ref in ((q, rq), (attn0, ra)):
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("depth,v,r,s,masked", [(8, 10, 24, 192, False),
                                                (3, 4, 5, 13, True),
                                                (2, 3, 140, 40, True)])
def test_chain_kernel_bf16_within_derived_bound(depth, v, r, s, masked):
    """bf16: the tensor-core kernel and the plain chain both in bf16, against
    the plain chain in f32 on the same bf16 inputs and bf16-valued weights.
    The kernel rounds the operands of every product to bf16 (x, LayerNorm
    outputs, hidden layers, qp, kp - qp + p, o, the attention probabilities,
    K and V) and keeps the sums, the residual stream, the LayerNorm
    statistics and both softmaxes in f32; the plain chain rounds all of
    those too, so the kernel's error must not exceed the plain chain's.
    Covers an odd number of views, S not a multiple of 16 or 32, more rays
    than blocks and a ray with every view masked."""
    _require_cuda()
    net, merged, emb = _chain_case(depth=depth, v=v, r=r, s=s, device="cuda",
                                   masked_ray=masked)
    mb, eb = merged.bfloat16(), emb.bfloat16()
    before = chain.gnt_chain.launches
    with torch.no_grad():
        ref = chain.gnt_chain_plain(_rounded(net, torch.bfloat16), mb.float(),
                                    eb.float())
        got = chain.gnt_chain(net, mb, eb)
        plain = chain.gnt_chain_plain(net, mb, eb)
    torch.cuda.synchronize()
    assert chain.gnt_chain.launches == before + 1
    for k in range(2):
        assert bool(torch.isfinite(got[k]).all())
        err_k = float((got[k].float() - ref[k]).abs().max())
        err_p = float((plain[k].float() - ref[k]).abs().max())
        assert err_k <= err_p, (k, err_k, err_p)


# ---- ray attention (ops/ray_attention.py, csrc/ray_attention.cu) ----

def _ra_case(r, s, seed=0, dtype=torch.float32, device="cpu", d=64):
    """Seeded operands and cotangents: x ~ N(0, 1) as after a LayerNorm,
    weights ~ U(-1/sqrt(D), 1/sqrt(D)) as a Linear's init."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: torch.as_tensor(rng.randn(*shape).astype(np.float32),
                                       device=device)
    u = lambda *shape: torch.as_tensor(
        ((rng.rand(*shape) * 2 - 1) / np.sqrt(d)).astype(np.float32),
        device=device)
    x, gout, gattn0 = f(r, s, d).to(dtype), f(r, s, d).to(dtype), \
        f(r, s).to(dtype)
    return x, u(d, 3 * d), u(d, d), u(d), gout, gattn0


def test_ray_attention_cpu_launches_nothing_and_differentiates():
    """On CPU tensors the autograd.Function runs the two plain versions: no
    launch is counted, and its gradients equal autograd's through the plain
    forward (the hand-written backward formulas, f32: 1e-5)."""
    x, wqkv, wo, bo, gout, gattn0 = _ra_case(3, 10)
    leaves = [t.clone().requires_grad_() for t in (x, wqkv, wo, bo)]
    before = ra.ray_attention_fwd.launches, ra.ray_attention_bwd.launches
    out, attn0 = ra.ray_attention(*leaves)
    got = torch.autograd.grad((out * gout).sum() + (attn0 * gattn0).sum(),
                              leaves)
    assert (ra.ray_attention_fwd.launches,
            ra.ray_attention_bwd.launches) == before
    ro, ra0 = ra.ray_attention_plain(*leaves)
    torch.testing.assert_close(out, ro, rtol=0, atol=0)
    ref = torch.autograd.grad((ro * gout).sum() + (ra0 * gattn0).sum(), leaves)
    for g, r_ in zip(got, ref):
        torch.testing.assert_close(g, r_, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(attn0.sum(-1), torch.ones(3), rtol=0,
                               atol=1e-5)


def test_ray_attention_rejects_bad_inputs():
    x, wqkv, wo, bo, gout, gattn0 = _ra_case(2, 8)
    with pytest.raises(ValueError, match="dtype"):
        ra.ray_attention_fwd(x.double(), wqkv, wo, bo)
    with pytest.raises(ValueError, match="wqkv"):
        ra.ray_attention_fwd(x, wqkv[:, :-1], wo, bo)
    with pytest.raises(ValueError, match="bo"):
        ra.ray_attention_fwd(x, wqkv, wo, bo[:-1])
    with pytest.raises(ValueError, match="gout"):
        ra.ray_attention_bwd(x, wqkv, wo, gout[:1], gattn0)
    with pytest.raises(ValueError, match="gattn0"):
        ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0.bfloat16())
    with pytest.raises(ValueError, match="device"):
        ra.ray_attention_fwd(*(t.to("meta") for t in (x, wqkv, wo, bo)))


def _ra_grads(fn, x, wqkv, wo, bo, gout, gattn0):
    leaves = [t.clone().requires_grad_() for t in (x, wqkv, wo, bo)]
    out, attn0 = fn(*leaves)
    loss = (out.float() * gout.float()).sum()
    if gattn0 is not None:
        loss = loss + (attn0.float() * gattn0.float()).sum()
    return (out, attn0) + torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(3, 10), (2, 8), (40, 192), (133, 77)])
@pytest.mark.parametrize("both", [True, False])
def test_ray_attention_kernels_match_plain_f32(r, s, both):
    """f32, forward and backward kernels through the autograd.Function
    against autograd through the plain forward: summation order only, 1e-5
    of each tensor's scale. ``both``: the cotangent feeds out and attn0, or
    out only. Covers S not a multiple of 4 and more rays than blocks."""
    _require_cuda()
    args = _ra_case(r, s, seed=r, device="cuda")
    if not both:
        args = args[:5] + (None,)
    before = ra.ray_attention_fwd.launches, ra.ray_attention_bwd.launches
    got = _ra_grads(ra.ray_attention, *args)
    torch.cuda.synchronize()
    assert (ra.ray_attention_fwd.launches,
            ra.ray_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = _ra_grads(ra.ray_attention_plain, *args)
    for name, g, r_ in zip(("out", "attn0", "dx", "dwqkv", "dwo", "dbo"),
                           got, ref):
        assert bool(torch.isfinite(g).all()), name
        g, r_ = g.detach(), r_.detach()
        tol = 1e-5 * max(1.0, float(r_.abs().max()))
        assert float((g - r_).abs().max()) <= tol, (name, tol)


@pytest.mark.cuda
def test_ray_attention_bwd_kernel_matches_plain_bwd():
    """The backward wrapper alone against the plain backward (the same
    formulas in tensor ops), and its ``want_dw=False`` route."""
    _require_cuda()
    x, wqkv, wo, bo, gout, gattn0 = _ra_case(20, 64, seed=5, device="cuda")
    got = ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0)
    ref = ra.ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0)
    for g, r_ in zip(got, ref):
        tol = 1e-5 * max(1.0, float(r_.abs().max()))
        assert float((g - r_).abs().max()) <= tol
    dx, dwqkv, dwo = ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0,
                                          want_dw=False)
    assert dwqkv is None and dwo is None
    torch.testing.assert_close(dx, got[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_ray_attention_kernels_bf16_within_derived_bound():
    """bf16: kernel and plain bf16 versions against the plain f32 version on
    the same bf16 inputs and bf16-valued weights. The plain bf16 version
    rounds every product; the kernels keep f32 inside and round only their
    outputs, so each output's error may not exceed the plain version's."""
    _require_cuda()
    x, wqkv, wo, bo, gout, gattn0 = _ra_case(24, 192, seed=2, device="cuda",
                                             dtype=torch.bfloat16)
    wb = [w.bfloat16().float() for w in (wqkv, wo, bo)]
    f32 = lambda t: t.float()
    ref = ra.ray_attention_plain(f32(x), *wb) + ra.ray_attention_bwd_plain(
        f32(x), wb[0], wb[1], f32(gout), f32(gattn0))
    got = ra.ray_attention_fwd(x, wqkv, wo, bo) + ra.ray_attention_bwd(
        x, wqkv, wo, gout, gattn0)
    plain = ra.ray_attention_plain(x, wqkv, wo, bo) + \
        ra.ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0)
    torch.cuda.synchronize()
    for name, g, p, r_ in zip(("out", "attn0", "dx", "dwqkv", "dwo"), got,
                              plain, ref):
        err_k = float((g.float() - r_).abs().max())
        err_p = float((p.float() - r_).abs().max())
        assert err_k <= err_p, (name, err_k, err_p)


@pytest.mark.cuda
def test_ray_attention_kernel_raises_on_unsupported_shape():
    _require_cuda()
    x, wqkv, wo, bo, _, _ = _ra_case(2, 8, device="cuda", d=32)
    with pytest.raises(ValueError, match="kernel takes"):
        ra.ray_attention_fwd(x, wqkv, wo, bo)
    torch.cuda.synchronize()  # nothing ran on the other width's weights
    x, wqkv, wo, bo, _, _ = _ra_case(2, 400, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ra.ray_attention_fwd(x, wqkv, wo, bo)
    torch.cuda.synchronize()


def _tf32_trunc(x):
    """f32 ``x`` with its 13 low mantissa bits cleared (how the forward
    kernel splits its operands, and how the tensor cores read an f32)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _split_trunc(x):
    """The forward kernel's own split: hi = x truncated to TF32, lo = x - hi
    read truncated by the tensor cores."""
    hi = _tf32_trunc(x)
    return hi, _tf32_trunc(x - hi)


def _mm3(a, b, split_b):
    """``a @ b`` as three TF32 products summed in f32, ``a`` split as the
    kernel splits its A operands and ``b`` by ``split_b``."""
    ah, al = _split_trunc(a)
    bh, bl = split_b(b)
    return al @ bh + ah @ bl + ah @ bh


_RA_STEP = 32  # keys per online-softmax step
_LOG2E = 1.4426950408889634


def _ra_emulated(x, wqkv, wo, bo, mm, n_heads=4):
    """The forward kernel's f32 arithmetic in tensor ops: ``mm(a, b, w)``
    for each of its four products (``w``: b is a host-packed weight),
    k | v for the samples padded to whole 32-key steps on clamped rows,
    the scores in log2 units, a flash-order online softmax over 32-key
    steps with keys past S at -1e9, and attn0 from a second pass over row
    0's scores (an f32 dot product) once the row's max and sum are final.

    :return: (out [R, S, D], attn0 [R, S])
    """
    r, s, d = x.shape
    hd = d // n_heads
    sp = -(-s // _RA_STEP) * _RA_STEP
    xp = x[:, torch.clamp(torch.arange(sp), max=s - 1)]
    kv = mm(xp, wqkv[:, d:], True)
    q = mm(x, wqkv[:, :d], True) * torch.tensor(0.25 * _LOG2E)
    keys = torch.arange(sp)
    heads, a0 = [], torch.zeros(r, sp)
    for h in range(n_heads):
        qh = q[..., h * hd:(h + 1) * hd]
        kh = kv[..., h * hd:(h + 1) * hd]
        vh = kv[..., d + h * hd:d + (h + 1) * hd]
        m = torch.full((r, s, 1), -float("inf"))
        l = torch.zeros(r, s, 1)
        o = torch.zeros(r, s, hd)
        for j0 in range(0, sp, _RA_STEP):
            blk = slice(j0, j0 + _RA_STEP)
            sc = mm(qh, kh[:, blk].transpose(1, 2), False)
            sc = sc.masked_fill(keys[blk] >= s, -1e9)
            mn = torch.maximum(m, sc.amax(-1, keepdim=True))
            c = torch.exp2(m - mn)
            p = torch.exp2(sc - mn)
            l = l * c + p.sum(-1, keepdim=True)
            o = o * c + mm(p, vh[:, blk], False)
            m = mn
        heads.append(o / l)
        s0 = (qh[:, :1] @ kh.transpose(1, 2))[:, 0]  # [R, Sp]
        a0 = a0 + torch.exp2(s0 - m[:, 0]) / l[:, 0] / n_heads
    out = mm(torch.cat(heads, dim=-1), wo, True) + bo
    return out, a0[:, :s]


def _ra_split_mm(a, b, weight):
    return _mm3(a, b, va.tf32_split if weight else _split_trunc)


def _ra_tf32_mm(a, b, weight):
    return va.tf32_round(a) @ va.tf32_round(b)


@pytest.mark.parametrize("r,s", [(24, 192), (40, 10), (40, 33)])
def test_ray_attention_tf32_split_within_f32_tolerance(r, s):
    """K3 forward's f32 route: its four products as three TF32 products
    (weights split to nearest on the host, operands truncated in the
    kernel), the online softmax in log2 units over 32-key steps and attn0
    from a second pass, emulated on the CPU at the slice's widths (D = 64, 4
    heads; S = 192 and the ragged 10 and 33), stay under the 1e-5 of scale
    that the card holds the kernel to against the plain version, within
    1e-6 of scale of float64 as the plain f32 version is (1.4e-7 against
    plain f32's 6.5e-8 at S = 192); one TF32 product alone (TF32 mode, 8e-5
    to 2.4e-4) would not. The tensor cores' own truncating f32 additions are
    not emulated: the kernel bounds them by adding every few k steps in f32,
    and the card holds it to the plain version."""
    x, wqkv, wo, bo, _, _ = _ra_case(r, s, seed=s)
    with torch.no_grad():
        truth = ra.ray_attention_plain(*(t.double() for t in
                                         (x, wqkv, wo, bo)))
        plain = ra.ray_attention_plain(x, wqkv, wo, bo)
        split = _ra_emulated(x, wqkv, wo, bo, _ra_split_mm)
        tf32 = _ra_emulated(x, wqkv, wo, bo, _ra_tf32_mm)
    for i, name in enumerate(("out", "attn0")):
        scale = max(1.0, float(truth[i].abs().max()))
        err = lambda y: float((y[i].double() - truth[i]).abs().max()) / scale
        assert split[i].shape == truth[i].shape, name
        assert err(split) <= 1e-6 and err(plain) <= 1e-6, (
            name, err(split), err(plain))
        assert float((split[i] - plain[i]).abs().max()) <= 1e-5 * scale, name
        if name == "out":
            assert err(tf32) > 1e-5, err(tf32)
    torch.testing.assert_close(split[1].sum(-1), torch.ones(r), rtol=0,
                               atol=1e-5)


def _frag_a(m16, kt):
    """The logical A [16, 8] of k step ``kt`` that the forward kernel builds
    from ``m16 [16, K]``, lane (g, t) by lane: ``x_frag`` from rows of x,
    ``c_to_a`` from a C fragment (n-tile kt's elements c0 = (g, 2t), c1 =
    (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1) become a0 = c0, a1 =
    c2, a2 = c1, a3 = c3); mma reads a0 at (g, t), a1 at (g + 8, t), a2 at
    (g, t + 4), a3 at (g + 8, t + 4)."""
    am = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c = (m16[g, 8 * kt + 2 * t], m16[g, 8 * kt + 2 * t + 1],
             m16[g + 8, 8 * kt + 2 * t], m16[g + 8, 8 * kt + 2 * t + 1])
        am[g, t], am[g + 8, t], am[g, t + 4], am[g + 8, t + 4] = (
            c[0], c[2], c[1], c[3])
    return am


def _frag_b(b0b1):
    """The logical B [8, 8] of a step from each lane's (b0, b1): mma reads
    b0 at (t, g) and b1 at (t + 4, g)."""
    bm = np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        bm[t, g], bm[t + 4, g] = b0b1(g, t)
    return bm


def test_ray_attention_packed_weights_reproduce_products():
    """``pack_b_tf32``'s blobs of Wqkv [64, 192] and Wo [64, 64], read
    through the forward kernel's lane indexing (uint4 ``((kt * 24 + nt) <<
    5) + lane`` of Wqkv: n-tiles 8 + nt of k and 16 + nt of v in the k | v
    product, 2h + n of q_h; ``(((2h + n) * 8 + nt) << 5) + lane`` of Wo with
    o_h's C fragments as A), reproduce x @ Wqkv and concat_h(o_h) @ Wo."""
    rng = np.random.RandomState(3)
    x = rng.randn(16, 64)
    o = rng.randn(16, 64)
    wqkv = torch.as_tensor(rng.randn(64, 192).astype(np.float32))
    wo = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    bq = np.asarray(va.pack_b_tf32(wqkv), np.float64).reshape(-1, 4)
    bo_ = np.asarray(va.pack_b_tf32(wo), np.float64).reshape(-1, 4)
    lanes = lambda blob, base: _frag_b(
        lambda g, t: (blob[base + 4 * g + t][0] + blob[base + 4 * g + t][2],
                      blob[base + 4 * g + t][1] + blob[base + 4 * g + t][3]))
    qkv = np.zeros((16, 192))
    for kt in range(8):
        am = _frag_a(x, kt)
        for half in range(2):  # the k | v product's n-tiles
            for nt in range(8):
                col = 8 * (1 + half) + nt
                qkv[:, 8 * col:8 * col + 8] += am @ lanes(
                    bq, (kt * 24 + col) << 5)
        for h in range(4):  # q_h's n-tiles
            for n in range(2):
                col = 2 * h + n
                qkv[:, 8 * col:8 * col + 8] += am @ lanes(
                    bq, (kt * 24 + col) << 5)
    ref = x @ wqkv.double().numpy()
    assert np.abs(qkv - ref).max() <= 1e-5 * np.abs(ref).max()
    out = np.zeros((16, 64))
    for h in range(4):
        for n in range(2):
            am = _frag_a(o, 2 * h + n)
            for nt in range(8):
                out[:, 8 * nt:8 * nt + 8] += am @ lanes(
                    bo_, ((2 * h + n) * 8 + nt) << 5)
    ref = o @ wo.double().numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_ray_attention_shared_kv_fragments_reproduce_products():
    """K and V as the forward kernel reads them from shared memory (K's B
    fragment: row j0 + 8 nt + g, channels 16h + 8 kt + 2t and + 1; V's: rows
    j0 + 8 kk + 2t and + 1, channel 16h + 8n + g) against q_h's and the
    scores' C fragments as A reproduce q_h k_h^T and p v_h over a 32-key
    step, for every head."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(16, 64), rng.randn(64, 64), rng.randn(64, 64))
    j0 = 32
    for h in range(4):
        sc = np.zeros((16, 32))
        for nt in range(4):
            for kt in range(2):
                bm = _frag_b(lambda g, t: (
                    k[j0 + 8 * nt + g, 16 * h + 8 * kt + 2 * t],
                    k[j0 + 8 * nt + g, 16 * h + 8 * kt + 2 * t + 1]))
                sc[:, 8 * nt:8 * nt + 8] += _frag_a(
                    q[:, 16 * h:16 * h + 16], kt) @ bm
        ref = q[:, 16 * h:16 * h + 16] @ k[j0:j0 + 32, 16 * h:16 * h + 16].T
        np.testing.assert_allclose(sc, ref, rtol=1e-12, atol=1e-12)
        pv = np.zeros((16, 16))
        for kk in range(4):
            for n in range(2):
                bm = _frag_b(lambda g, t: (
                    v[j0 + 8 * kk + 2 * t, 16 * h + 8 * n + g],
                    v[j0 + 8 * kk + 2 * t + 1, 16 * h + 8 * n + g]))
                pv[:, 8 * n:8 * n + 8] += _frag_a(ref, kk) @ bm
        np.testing.assert_allclose(
            pv, ref @ v[j0:j0 + 32, 16 * h:16 * h + 16], rtol=1e-12,
            atol=1e-10)


def test_ray_attention_bwd_packed_weights_reproduce_products():
    """``pack_b_tf32``'s blobs of Wo^T [64, 64] and Wqkv^T [192, 64], read
    through the backward kernel's lane indexing (uint4 ``((kt * 8 + 2h + n)
    << 5) + lane`` of Wo^T with gout's rows as A, for go_h's n-tile n; ``((kt
    * 8 + nt) << 5) + lane`` of Wqkv^T at k step kt = 8b + 2h + n, with the C
    fragments of dq_h, dk_h, dv_h (b = 0, 1, 2) as A), reproduce gout Wo^T
    and gqkv Wqkv^T."""
    rng = np.random.RandomState(5)
    gout = rng.randn(16, 64)
    gqkv = rng.randn(16, 192)
    wqkv = torch.as_tensor(rng.randn(64, 192).astype(np.float32))
    wo = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    bot = np.asarray(va.pack_b_tf32(wo.t()), np.float64).reshape(-1, 4)
    bqt = np.asarray(va.pack_b_tf32(wqkv.t()), np.float64).reshape(-1, 4)
    lanes = lambda blob, base: _frag_b(
        lambda g, t: (blob[base + 4 * g + t][0] + blob[base + 4 * g + t][2],
                      blob[base + 4 * g + t][1] + blob[base + 4 * g + t][3]))
    go = np.zeros((16, 64))
    for h in range(4):
        for n in range(2):
            for kt in range(8):
                go[:, 16 * h + 8 * n:16 * h + 8 * n + 8] += _frag_a(
                    gout, kt) @ lanes(bot, (kt * 8 + 2 * h + n) << 5)
    ref = gout @ wo.double().numpy().T
    assert np.abs(go - ref).max() <= 1e-5 * np.abs(ref).max()
    dx = np.zeros((16, 64))
    for h in range(4):
        for b in range(3):
            for n in range(2):
                kt = 8 * b + 2 * h + n
                am = _frag_a(gqkv, kt)  # columns 8 kt.. of gqkv: head h's
                for nt in range(8):
                    dx[:, 8 * nt:8 * nt + 8] += am @ lanes(
                        bqt, (kt * 8 + nt) << 5)
    ref = gqkv @ wqkv.double().numpy().T
    assert np.abs(dx - ref).max() <= 1e-5 * np.abs(ref).max()


def test_ray_attention_bwd_shared_fragments_reproduce_products():
    """The backward's per-head buffers as it reads them from shared memory
    ([Sp, 16] rows; a row's B fragment: row j0 + 8 nt + g, channels 8 kt +
    2t and + 1; a column's: rows j0 + 8 kk + 2t and + 1, channel 8n + g),
    with a tile's rows or a product's C fragments as A, reproduce over a
    32-row step the scores q k^T, dp = go v^T, their transposes k q^T and v
    go^T, and dq = ds k, dk = ds^T q, dv = p^T go."""
    rng = np.random.RandomState(6)
    q, k, v, go = (rng.randn(64, 16) for _ in range(4))
    j0, r0 = 32, 16  # the step's rows; the tile's rows

    def rows(a16, m):  # a16 [16, 16] @ m[j0:j0 + 32].T
        c = np.zeros((16, 32))
        for nt in range(4):
            for kt in range(2):
                c[:, 8 * nt:8 * nt + 8] += _frag_a(a16, kt) @ _frag_b(
                    lambda g, t: (m[j0 + 8 * nt + g, 8 * kt + 2 * t],
                                  m[j0 + 8 * nt + g, 8 * kt + 2 * t + 1]))
        return c

    def cols(c32, m):  # c32 [16, 32] @ m[j0:j0 + 32]
        out = np.zeros((16, 16))
        for kk in range(4):
            for n in range(2):
                out[:, 8 * n:8 * n + 8] += _frag_a(c32, kk) @ _frag_b(
                    lambda g, t: (m[j0 + 8 * kk + 2 * t, 8 * n + g],
                                  m[j0 + 8 * kk + 2 * t + 1, 8 * n + g]))
        return out

    tile = slice(r0, r0 + 16)
    step = slice(j0, j0 + 32)
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-12,
                                                    atol=1e-10)
    close(rows(q[tile], k), q[tile] @ k[step].T)
    close(rows(go[tile], v), go[tile] @ v[step].T)
    close(rows(k[tile], q), k[tile] @ q[step].T)
    close(rows(v[tile], go), v[tile] @ go[step].T)
    ds = rng.randn(16, 32)
    close(cols(ds, k), ds @ k[step])
    close(cols(ds, q), ds @ q[step])
    close(cols(ds, go), ds @ go[step])


def test_ray_attention_bwd_weight_gradient_fragments_reproduce_products():
    """Phase D of the backward with the weight gradients, lane by lane as
    the kernel indexes it, at S = 10 (two 8-row k steps, rows past S read
    clamped from x and gout and zero in the shared o_h and dq | dk | dv):
    warp w's A fragments of x^T (channels 16 (w % 4).., rows 8 kk + 2t and
    + 1) and B fragments of the q, k or v third w / 4 of a head's dq | dk |
    dv, and warps 0-7's o_h^T and gout columns 8 w.., written as C
    fragments into a block's partial sums ([D][3D] then [D][D]), reproduce
    dWqkv = x^T gqkv and dWo = concat_h(o_h)^T gout over the four heads."""
    rng = np.random.RandomState(8)
    d, nh, hd, s_ = 64, 4, 16, 10
    sp = 32
    x, gout = rng.randn(s_, d), rng.randn(s_, d)
    gqkv, cat = rng.randn(s_, 3 * d), rng.randn(s_, d)
    part = np.zeros(d * 3 * d + d * d)
    for h in range(nh):
        gq = np.zeros((sp, 3 * hd))  # shared dq | dk | dv, rows past S 0
        for b in range(3):
            gq[:s_, b * hd:(b + 1) * hd] = gqkv[:, b * d + h * hd:
                                                b * d + (h + 1) * hd]
        o = np.zeros((sp, hd))
        o[:s_] = cat[:, h * hd:(h + 1) * hd]
        for warp in range(12):
            m0, b = 16 * (warp % 4), warp // 4
            for n in range(2):
                acc = np.zeros((16, 8))
                for kk in range((s_ + 7) // 8):
                    am, bm = np.zeros((16, 8)), np.zeros((8, 8))
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        r0 = 8 * kk + 2 * t
                        x0, x1 = x[min(r0, s_ - 1)], x[min(r0 + 1, s_ - 1)]
                        am[g, t], am[g + 8, t] = x0[m0 + g], x0[m0 + g + 8]
                        am[g, t + 4], am[g + 8, t + 4] = (x1[m0 + g],
                                                          x1[m0 + g + 8])
                        bm[t, g] = gq[r0, b * hd + 8 * n + g]
                        bm[t + 4, g] = gq[r0 + 1, b * hd + 8 * n + g]
                    acc += am @ bm
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    i = (m0 + g) * 3 * d + b * d + h * hd + 8 * n + 2 * t
                    part[i:i + 2] += acc[g, 2 * t:2 * t + 2]
                    part[i + 8 * 3 * d:i + 8 * 3 * d + 2] += acc[
                        g + 8, 2 * t:2 * t + 2]
            if warp < 8:
                acc = np.zeros((16, 8))
                for kk in range((s_ + 7) // 8):
                    am, bm = np.zeros((16, 8)), np.zeros((8, 8))
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        r0 = 8 * kk + 2 * t
                        am[g, t], am[g + 8, t] = o[r0, g], o[r0, g + 8]
                        am[g, t + 4], am[g + 8, t + 4] = (o[r0 + 1, g],
                                                          o[r0 + 1, g + 8])
                        bm[t, g] = gout[min(r0, s_ - 1), 8 * warp + g]
                        bm[t + 4, g] = gout[min(r0 + 1, s_ - 1),
                                            8 * warp + g]
                    acc += am @ bm
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    i = d * 3 * d + (h * hd + g) * d + 8 * warp + 2 * t
                    part[i:i + 2] += acc[g, 2 * t:2 * t + 2]
                    part[i + 8 * d:i + 8 * d + 2] += acc[g + 8,
                                                         2 * t:2 * t + 2]
    close = lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-12,
                                                    atol=1e-10)
    close(part[:d * 3 * d].reshape(d, 3 * d), x.T @ gqkv)
    close(part[d * 3 * d:].reshape(d, d), cat.T @ gout)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(800, 192), (4096, 192), (3, 10), (5, 33)])
def test_ray_attention_fwd_kernel_matches_plain_f32(r, s):
    """The tensor-core forward in f32 (every product three TF32 products,
    the softmax online over 32-key steps) against the plain version at the
    attack batch's shape, a render chunk's and two ragged S: 1e-5 of each
    output's scale, one launch counted."""
    _require_cuda()
    x, wqkv, wo, bo, _, _ = _ra_case(r, s, seed=r + s, device="cuda")
    before = ra.ray_attention_fwd.launches
    got = ra.ray_attention_fwd(x, wqkv, wo, bo)
    torch.cuda.synchronize()
    assert ra.ray_attention_fwd.launches == before + 1
    ref = ra.ray_attention_plain(x, wqkv, wo, bo)
    for name, g, r_ in zip(("out", "attn0"), got, ref):
        assert g.shape == r_.shape and bool(torch.isfinite(g).all()), name
        tol = 1e-5 * max(1.0, float(r_.abs().max()))
        assert float((g - r_).abs().max()) <= tol, (name, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(800, 192), (4096, 192), (3, 10), (5, 33)])
def test_ray_attention_fwd_kernel_bf16_within_derived_bound(r, s):
    """bf16 forward: the kernel loads bf16 as f32, computes as on the f32
    route and rounds its outputs, so against the plain f32 version on the
    same bf16 inputs and bf16-valued weights it may err no more than the
    plain bf16 version, which rounds every product."""
    _require_cuda()
    x, wqkv, wo, bo, _, _ = _ra_case(r, s, seed=r + s + 1, device="cuda",
                                     dtype=torch.bfloat16)
    wb = [w.bfloat16().float() for w in (wqkv, wo, bo)]
    ref = ra.ray_attention_plain(x.float(), *wb)
    got = ra.ray_attention_fwd(x, wqkv, wo, bo)
    plain = ra.ray_attention_plain(x, wqkv, wo, bo)
    torch.cuda.synchronize()
    for name, g, p, r_ in zip(("out", "attn0"), got, plain, ref):
        assert g.dtype == torch.bfloat16, name
        err_k = float((g.float() - r_).abs().max())
        err_p = float((p.float() - r_).abs().max())
        assert err_k <= err_p, (name, err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(800, 192), (3, 10), (5, 33)])
@pytest.mark.parametrize("both", [True, False], ids=["out+attn0", "out"])
@pytest.mark.parametrize("want_dw", [True, False], ids=["dw", "no_dw"])
def test_ray_attention_bwd_kernel_matches_plain_f32(r, s, both, want_dw):
    """The tensor-core backward in f32 against ``ray_attention_bwd_plain``
    at the attack batch's shape and two ragged S (10: one tile with rows
    past S; 33: neither a multiple of 16 nor of 32), under both cotangents,
    with and without weight gradients: 1e-5 of each output's scale, one
    launch counted."""
    _require_cuda()
    x, wqkv, wo, _, gout, gattn0 = _ra_case(r, s, seed=r + s + both,
                                            device="cuda")
    if not both:
        gattn0 = torch.zeros_like(gattn0)
    before = ra.ray_attention_bwd.launches
    got = ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0, want_dw=want_dw)
    torch.cuda.synchronize()
    assert ra.ray_attention_bwd.launches == before + 1
    ref = ra.ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0)
    if not want_dw:
        assert got[1] is None and got[2] is None
    for name, g, r_ in zip(("dx", "dwqkv", "dwo"), got, ref):
        if g is None:
            continue
        assert g.shape == r_.shape and bool(torch.isfinite(g).all()), name
        tol = 1e-5 * max(1.0, float(r_.abs().max()))
        assert float((g - r_).abs().max()) <= tol, (name, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(3, 10), (5, 33)])
def test_ray_attention_bwd_rows_past_s_contribute_nothing(r, s):
    """The backward pads the samples to whole 32-row steps; it computes the
    rows past S from x and gout read clamped to row S - 1 and stores them as
    zeros, with zero softmax statistics. Those rows must carry no cotangent:
    with row S - 1's gout 1e3 times larger, a padded copy of it would add
    itself again to every key's dk and dv, and to the weight gradients. dx
    and the weight gradients still equal the plain version's to 1e-5 of
    their scale."""
    _require_cuda()
    x, wqkv, wo, _, gout, gattn0 = _ra_case(r, s, seed=7, device="cuda")
    gout[:, -1] *= 1e3
    gattn0[:, -1] *= 1e3
    got = ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0)
    torch.cuda.synchronize()
    ref = ra.ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0)
    for name, g, r_ in zip(("dx", "dwqkv", "dwo"), got, ref):
        assert bool(torch.isfinite(g).all()), name
        tol = 1e-5 * max(1.0, float(r_.abs().max()))
        assert float((g - r_).abs().max()) <= tol, (name, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(800, 192), (3, 10)])
@pytest.mark.parametrize("want_dw", [True, False], ids=["dw", "no_dw"])
def test_ray_attention_bwd_kernel_bf16_within_derived_bound(r, s, want_dw):
    """bf16 backward: the kernel loads bf16 as f32, computes as on the f32
    route and rounds dx, so against the plain f32 version on the same bf16
    inputs and bf16-valued weights it may err no more than the plain bf16
    version, which rounds every product."""
    _require_cuda()
    x, wqkv, wo, _, gout, gattn0 = _ra_case(r, s, seed=r + s + 3,
                                            device="cuda",
                                            dtype=torch.bfloat16)
    wb = [w.bfloat16().float() for w in (wqkv, wo)]
    ref = ra.ray_attention_bwd_plain(x.float(), *wb, gout.float(),
                                     gattn0.float())
    got = ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0, want_dw=want_dw)
    plain = ra.ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    for name, g, p, r_ in zip(("dx", "dwqkv", "dwo"), got, plain, ref):
        if g is None:
            continue
        err_k = float((g.float() - r_).abs().max())
        err_p = float((p.float() - r_).abs().max())
        assert err_k <= err_p, (name, err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ray_attention_weights_packed_on_the_card_as_pack_b_tf32(dtype):
    """The pack kernel writes ``pack_b_tf32``'s blobs of the weights rounded
    to the route's dtype, bit for bit: Wqkv and Wo (the forward's), then
    Wo^T and Wqkv^T (the backward's)."""
    _require_cuda()
    _, wqkv, wo, _, _, _ = _ra_case(2, 8, device="cuda")
    got = ra.pack_weights(ra.build(), wqkv, wo, dtype)
    torch.cuda.synchronize()
    want = torch.cat([va.pack_b_tf32(w.to(dtype).float()) for w in (
        wqkv, wo, wo.t(), wqkv.t())])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ray_attention_module_keeps_wqkv_while_weights_unchanged():
    """``RayAttention`` hands the kernel the same ``[D, 3D]`` tensor while
    its weights keep their values and take no gradient (so the kernel's
    packed copy is reused), a new one after an in-place write, a fresh
    differentiable one where the weights take gradients, and never an
    inference tensor; the fused route follows the written weights."""
    from nerfool_tpu_torch.models.gnt import RayAttention

    torch.manual_seed(0)
    mod = RayAttention(64)
    x = torch.randn(3, 10, 64)

    def cat():
        return torch.cat([mod.q_fc.weight, mod.k_fc.weight,
                          mod.v_fc.weight]).t()

    with torch.no_grad():
        kept = mod._wqkv()
        assert mod._wqkv() is kept and torch.equal(kept, cat())
        mod.k_fc.weight.mul_(2.0)
        new = mod._wqkv()
        assert new is not kept and torch.equal(new, cat())
        out_f, attn0 = mod(x, fused=True)
        out_u, attn = mod(x)
    torch.testing.assert_close(out_f, out_u, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(attn0, attn.mean(1)[:, 0], atol=1e-6,
                               rtol=1e-5)
    fresh = mod._wqkv()
    assert fresh.grad_fn is not None and fresh is not mod._wqkv()
    mod.requires_grad_(False)
    with torch.no_grad():
        mod.v_fc.weight.add_(0.5)
    with torch.inference_mode():
        inf = mod._wqkv()
    assert not inf.is_inference() and torch.equal(inf, cat())
    assert mod._wqkv() is inf


def test_ray_attention_packs_module_weights_once_per_value(monkeypatch):
    """The forward's pack cache, keyed on the tensors' storage and version
    counter, with the pack itself counted in place of the card's: the
    module's weights as it passes them (under no_grad and inference mode)
    are packed once, again after an in-place write, and once per dtype."""
    from nerfool_tpu_torch.models.gnt import RayAttention

    packs = []
    monkeypatch.setattr(ra, "pack_weights",
                        lambda lib, wqkv, wo, dtype: packs.append(
                            (wqkv.clone(), dtype)) or object())
    monkeypatch.setattr(ra, "_lib", lambda: None)
    monkeypatch.setattr(ra, "_PACKED", type(ra._PACKED)())
    mod = RayAttention(64)

    def packed(dtype=torch.float32):
        return ra._packed(mod._wqkv(), mod.out_fc.weight.t(), dtype)

    with torch.no_grad():
        first = packed()
    with torch.inference_mode():
        assert packed() is first
    assert packed(torch.bfloat16) is not first and len(packs) == 2
    with torch.no_grad():
        mod.q_fc.weight.add_(1.0)
        again = packed()
    assert again is not first and len(packs) == 3
    assert torch.equal(packs[-1][0][:, :64], mod.q_fc.weight.t())
    with torch.no_grad():
        mod.out_fc.weight.mul_(2.0)
        assert packed() is not again and len(packs) == 4


@pytest.mark.cuda
def test_ray_attention_weights_packed_once_per_value():
    """The weights are packed once for each value: the same blob for
    the same tensors, a new one after an in-place write, after which the
    kernel still matches the plain version (1e-5 of scale)."""
    _require_cuda()
    x, wqkv, wo, bo, _, _ = _ra_case(4, 33, device="cuda")
    first = ra._packed(wqkv, wo, torch.float32)
    assert ra._packed(wqkv, wo, torch.float32) is first
    assert ra._packed(wqkv, wo, torch.bfloat16) is not first
    wqkv.mul_(-1.5)
    again = ra._packed(wqkv, wo, torch.float32)
    assert again is not first
    want = torch.cat([va.pack_b_tf32(w) for w in (wqkv, wo, wo.t(),
                                                   wqkv.t())])
    assert torch.equal(again.view(torch.int32), want.view(torch.int32))
    out, attn0 = ra.ray_attention_fwd(x, wqkv, wo, bo)
    ref = ra.ray_attention_plain(x, wqkv, wo, bo)
    for got, r_ in zip((out, attn0), ref):
        assert float((got - r_).abs().max()) <= 1e-5 * max(
            1.0, float(r_.abs().max()))


@pytest.mark.cuda
def test_ray_attention_shared_memory_is_sized_per_direction():
    """The forward keeps K and V (~564 B a sample), the backward the
    per-head buffers and its dx accumulator (688 B a sample), and with the
    weight gradients o_h and dq | dk | dv besides (976 B a sample): at S =
    256 the backward without them runs and the one with them raises; at S
    = 350 the forward runs and the backward raises; each names its own
    kernel and size."""
    _require_cuda()
    x, wqkv, wo, bo, gout, gattn0 = _ra_case(2, 256, device="cuda")
    dx = ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0, want_dw=False)[0]
    ref = ra.ray_attention_bwd_plain(x, wqkv, wo, gout, gattn0)[0]
    assert float((dx - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))
    with pytest.raises(ValueError, match="with the weight gradients"):
        ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0)
    x, wqkv, wo, bo, gout, gattn0 = _ra_case(2, 350, device="cuda")
    out, attn0 = ra.ray_attention_fwd(x, wqkv, wo, bo)
    ref = ra.ray_attention_plain(x, wqkv, wo, bo)
    assert float((out - ref[0]).abs().max()) <= 1e-5 * max(
        1.0, float(ref[0].abs().max()))
    with pytest.raises(ValueError, match="backward kernel"):
        ra.ray_attention_bwd(x, wqkv, wo, gout, gattn0, want_dw=False)
    x, wqkv, wo, bo, _, _ = _ra_case(2, 420, device="cuda")
    with pytest.raises(ValueError, match="forward kernel"):
        ra.ray_attention_fwd(x, wqkv, wo, bo)


# ---- view attention (ops/view_attention.py, csrc/view_attention.cu) ----

def _va_case(v, n, seed=0, dtype=torch.float32, device="cpu", d=64,
             masked_rows=0):
    """Seeded operands: qln and k ~ N(0, 1) as after a LayerNorm, ray
    differences with their dot near 1, ~20% of the views masked and the first
    ``masked_rows`` rows masked in every view; weights ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) as a Linear's init."""
    rng = np.random.RandomState(seed)
    f = lambda x: torch.as_tensor(x.astype(np.float32), device=device)
    u = lambda i, *shape: f((rng.rand(*shape) * 2 - 1) / np.sqrt(i))
    pos = 0.1 * rng.randn(v, n, 4)
    pos[..., 3] = 1.0 - np.abs(pos[..., 3])
    mask = (rng.rand(v, n, 1) > 0.2).astype(np.float32)
    mask[:, :masked_rows] = 0.0
    h = d // 8
    return (f(rng.randn(n, d)).to(dtype), f(rng.randn(v, n, d)).to(dtype),
            f(pos).to(dtype), f(mask).to(dtype),
            u(d, d, d), u(d, d, 2 * d), u(4, 4, h), u(4, h), u(h, h, d),
            u(h, d), u(d, d, h), u(d, h), u(h, h, d), u(h, d), u(d, d, d),
            u(d, d))


def test_view_attention_cpu_launches_nothing():
    """CPU tensors take the plain version; rows masked in every view get the
    uniform 1 / V weights: finite, and equal to the mean over the views."""
    args = _va_case(3, 15, masked_rows=4)
    before = va.view_attention.launches
    out = va.view_attention(*args, lane_pack=True)
    assert va.view_attention.launches == before
    torch.testing.assert_close(out, va.view_attention_plain(*args), rtol=0,
                               atol=0)
    assert out.shape == (15, 64) and bool(torch.isfinite(out).all())
    qln, k, pos, mask, wq, wkv, wp0, bp0, wp1, bp1 = args[:10]
    wo, bo = args[-2:]
    p = torch.relu(pos @ wp0 + bp0) @ wp1 + bp1
    mean = torch.mean((k @ wkv)[..., 64:] + p, dim=0) @ wo + bo
    torch.testing.assert_close(out[:4], mean[:4], rtol=1e-5, atol=1e-5)


def test_view_attention_is_forward_only():
    args = list(_va_case(2, 6))
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        va.view_attention(*args)
    with torch.no_grad():
        assert va.view_attention(*args).shape == (6, 64)
    args[1].requires_grad_(False)
    args[5].requires_grad_()  # a weight
    with pytest.raises(RuntimeError, match="forward only"):
        va.view_attention(*args)


def test_view_attention_rejects_bad_inputs():
    args = list(_va_case(2, 6))
    with pytest.raises(ValueError, match="wkv"):
        va.view_attention(*args[:5], args[5][:, :-1], *args[6:])
    with pytest.raises(ValueError, match="mask"):
        va.view_attention(*args[:3], args[3][:, :-1], *args[4:])
    with pytest.raises(ValueError, match="dtype"):
        va.view_attention(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="device"):
        va.view_attention(*(t.to("meta") for t in args))


def _tf32_fragment_product(a, packed, k, n):
    """``a [16, K] @ W`` through ``pack_b_tf32``'s blob read as the kernel
    reads it (numpy, float64): lane (g, t) holds A's rows g and g + 8 at the
    step's channels 8 kt + 2 t (logical column t) and 8 kt + 2 t + 1
    (logical column t + 4), and loads (hi0, hi1, lo0, lo1) of fragment
    (kt, nt); ``mma.m16n8k8`` multiplies the logical A [16, 8] by the
    logical B [8, 8] (b0 at row t, b1 at row t + 4, column g)."""
    blob = np.asarray(packed, np.float64).reshape(k // 8, n // 8, 32, 4)
    out = np.zeros((16, n))
    for kt in range(k // 8):
        am = np.zeros((16, 8))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in (g, g + 8):
                am[r, t] = a[r, 8 * kt + 2 * t]
                am[r, t + 4] = a[r, 8 * kt + 2 * t + 1]
        for nt in range(n // 8):
            bm = np.zeros((8, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                hi0, hi1, lo0, lo1 = blob[kt, nt, lane]
                bm[t, g], bm[t + 4, g] = hi0 + lo0, hi1 + lo1
            out[:, 8 * nt:8 * nt + 8] += am @ bm
    return out


def test_packed_tf32_weights_reproduce_products():
    """``pack_b_tf32`` read back through the kernel's lane indexing gives
    ``A @ W`` (hi + lo holds each weight to ~2^-22), and every hi and lo is
    a TF32 value (13 low mantissa bits clear)."""
    rng = np.random.RandomState(0)
    for k, n in ((64, 128), (64, 64)):
        w = torch.as_tensor(rng.randn(k, n).astype(np.float32))
        a = rng.randn(16, k)
        packed = va.pack_b_tf32(w)
        assert packed.numel() == 2 * k * n
        assert not (packed.view(torch.int32) & 0x1FFF).any()
        got = _tf32_fragment_product(a, packed, k, n)
        ref = a @ w.double().numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_packed_bf16_kernel_fragments_reproduce_products():
    """The bf16 route's A fragments (32-bit words 8 kt + t and 8 kt + 4 + t
    of rows g and g + 8: channels 16 kt + 2 t and 16 kt + 8 + 2 t, pairs)
    against ``pack_b``'s B fragments reproduce ``A @ W`` on bf16 values."""
    rng = np.random.RandomState(1)
    w = torch.as_tensor(rng.randn(64, 128).astype(np.float32)).bfloat16()
    a = torch.as_tensor(rng.randn(16, 64).astype(np.float32)).bfloat16()
    blob = chain.pack_b(w).float().numpy().reshape(4, 16, 32, 4)
    av = a.float().numpy()
    out = np.zeros((16, 128))
    for kt in range(4):
        am = np.zeros((16, 16))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for r in (g, g + 8):
                for c in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9):
                    am[r, c] = av[r, 16 * kt + c]
        for nt in range(16):
            bm = np.zeros((16, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    bm[2 * t + (e & 1) + 8 * (e >> 1), g] = blob[kt, nt, lane,
                                                                 e]
            out[:, 8 * nt:8 * nt + 8] += am @ bm
    ref = av.astype(np.float64) @ w.float().double().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def _split_matmul(a, w):
    """``a @ w`` as the kernel's three TF32 products, summed in f32."""
    ah, al = va.tf32_split(a)
    wh, wl = va.tf32_split(w)
    return al @ wh + ah @ wl + ah @ wh


def _va_emulated(qln, k, pos, mask, wq, wkv, wp0, bp0, wp1, bp1, wa0, ba0,
                 wa1, ba1, wo, bo, matmul):
    """The f32 view attention with its three D-wide products (qln Wq, k
    [Wk | Wk Wv], the output product) taken through ``matmul`` and the rest
    in f32, as the kernel's f32 route computes them."""
    d = qln.shape[-1]
    qp = matmul(qln, wq)
    kv = matmul(k.reshape(-1, d), wkv).reshape(k.shape[0], -1, 2 * d)
    kp, vv = kv[..., :d], kv[..., d:]
    p = torch.relu(pos @ wp0 + bp0) @ wp1 + bp1
    a = torch.relu((kp - qp[None] + p) @ wa0 + ba0) @ wa1 + ba1
    a = a.masked_fill(mask == 0, -1e9)
    x = torch.sum((vv + p) * torch.softmax(a, dim=0), dim=0)
    return matmul(x, wo) + bo


def test_view_attention_tf32_split_within_f32_tolerance():
    """K4's f32 route: its products as three TF32 products (hi hi + hi lo +
    lo hi), emulated on the CPU at the slice's widths (V = 10 views, D = 64,
    4096 rows), stay under the 1e-5 of scale that the card holds the kernel
    to against the plain version, as close to float64 as the plain f32
    version is; one TF32 product alone (TF32 mode) would not."""
    args = _va_case(10, 4096, seed=6, masked_rows=40)
    with torch.no_grad():
        truth = va.view_attention_plain(*(t.double() for t in args))
        plain = va.view_attention_plain(*args)
        split = _va_emulated(*args, matmul=_split_matmul)
        tf32 = _va_emulated(*args, matmul=lambda a, w: va.tf32_round(a)
                            @ va.tf32_round(w))
    scale = max(1.0, float(truth.abs().max()))
    err = lambda x: float((x.double() - truth).abs().max()) / scale
    assert err(split) <= 1e-6 and err(plain) <= 1e-6
    assert float((split - plain).abs().max()) <= 1e-5 * scale
    assert err(tf32) > 1e-5


def test_tf32_round_matches_round_to_nearest_away():
    """``tf32_round`` keeps 10 mantissa bits, to nearest with ties away from
    zero (``cvt.rna``), in both signs."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -11 - 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      3.0, 0.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, 1.0,
                         -(1.0 + 2.0 ** -10), 3.0, 0.0])
    assert torch.equal(va.tf32_round(x), want)
    hi, lo = va.tf32_split(torch.tensor([1.0 + 2.0 ** -20]))
    assert float(hi) == 1.0 and float(lo) == 2.0 ** -20


@pytest.mark.cuda
@pytest.mark.parametrize("v,n,masked_rows", [(3, 15, 4), (10, 64, 0),
                                             (10, 1000, 70), (4, 17000, 5),
                                             (9, 4099, 3)])
def test_view_attention_kernel_matches_plain_f32(v, n, masked_rows):
    """f32: the kernel's products are three TF32 products each (~2^-21 of
    every term) summed in another order than cuBLAS's, its softmax over the
    views online against a two-pass one: 1e-5 of the output's scale. Covers
    N below one warp's 8 rows and below a block's 64, N not a multiple of
    either, more groups than warps, odd V (a last view pair of one view) and
    rows masked in every view."""
    _require_cuda()
    args = _va_case(v, n, seed=n, device="cuda", masked_rows=masked_rows)
    before = va.view_attention.launches
    with torch.no_grad():
        out = va.view_attention(*args)
        torch.cuda.synchronize()
        assert va.view_attention.launches == before + 1
        ref = va.view_attention_plain(*args)
    assert bool(torch.isfinite(out).all())
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("v,n,masked_rows", [(10, 5000, 9), (3, 77, 5)])
def test_view_attention_kernel_bf16_within_derived_bound(v, n, masked_rows):
    """bf16: kernel and plain bf16 against plain f32 on the same bf16 inputs
    and bf16-valued weights. The plain bf16 version rounds after every
    operation; the kernel keeps f32 inside but for the output product's
    operand and rounds its output, so its error may not exceed the plain
    version's."""
    _require_cuda()
    args = _va_case(v, n, seed=3, device="cuda", dtype=torch.bfloat16,
                    masked_rows=masked_rows)
    with torch.no_grad():
        ref = va.view_attention_plain(
            *(t.bfloat16().float() for t in args))
        got = va.view_attention(*args)
        plain = va.view_attention_plain(*args)
    torch.cuda.synchronize()
    err_k = float((got.float() - ref).abs().max())
    err_p = float((plain.float() - ref).abs().max())
    assert err_k <= err_p, (err_k, err_p)


@pytest.mark.cuda
def test_view_attention_kernel_raises_on_unsupported_shape():
    _require_cuda()
    args = _va_case(2, 8, device="cuda", d=32)
    with pytest.raises(ValueError, match="kernel takes"):
        va.view_attention(*args)
    args = _va_case(2, 8, device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        va.view_attention(*(t.half() for t in args[:4]), *args[4:])


# ---- the depth warp's z-buffer on the card ----

def _look_at_k(eye, h, w):
    """(intrinsics [3, 3], c2w [4, 4]) of a camera at ``eye`` looking at the
    origin, OpenCV convention."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
    c2w[:3, 3] = eye
    k = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1.0]])
    return k.astype(np.float32), c2w.astype(np.float32)


def _frame_warp(device, h=378, w=504):
    """A source view's depth z-buffered into a neighbouring camera over the
    whole frame (the consistency terms' warp at the slice's 378x504)."""
    rng = np.random.RandomState(1)
    k_ref, e_ref = _look_at_k(np.array([0.0, 1.2, -4.0]), h, w)
    k_src, e_src = _look_at_k(np.array([1.0, 1.2, -3.9]), h, w)
    depth = (rng.rand(h, w) * 2 + 3.0).astype(np.float32)
    rgb = rng.rand(h, w, 3).astype(np.float32)
    sel = rng.choice(h * w, 512, replace=False)
    t = lambda x: torch.as_tensor(x, device=device)
    return warp.forward_warp(t(sel), t(rgb), t(depth), t(k_ref), t(e_ref),
                             t(k_src), t(e_src), src2tar=True,
                             derive_full_image=True)


@pytest.mark.cuda
def test_zbuffer_is_bit_identical_over_two_runs_on_the_card():
    """The scatter is a min: the order in which its atomics land cannot
    change the result."""
    _require_cuda()
    a, b = _frame_warp("cuda"), _frame_warp("cuda")
    assert int((a[1] > 0).sum()) > 1000
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_card_warp_matches_cpu_at_378x504():
    """The whole-frame warp on the card against the CPU's, 1e-5 relative at
    99.9% of the frame's pixels and 99% of the 512 selected ones: a landing
    coordinate within rounding of an integer may fall on either side, which
    moves a source pixel to a neighbouring target pixel (~1.5e-4 of the
    frame here)."""
    _require_cuda()
    for g, c in zip(_frame_warp("cuda"), _frame_warp("cpu")):
        close = np.isclose(g.cpu().numpy(), c.numpy(), rtol=1e-5, atol=0)
        assert close.mean() > (0.999 if g.numel() > 10_000 else 0.99), \
            close.mean()
