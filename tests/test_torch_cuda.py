"""paddle_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, the engine's token streams on the card against the
same engine on the CPU, and a training step's loss and grads on the card
against the CPU. Every test is marked ``cuda`` and skips without a GPU.
This file imports neither JAX nor paddle_tpu, so it runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

The fused AdamW/LAMB and int8 matmul kernels (both int8 entries: the
pre-quantized one and the one that quantizes in the same launch) are
held bit-identical to their plain versions (built with -fmad=false, they round where the plain
versions' separate operations round; an int32 sum is exact in any
order), and so is the MoE dispatch gather (a copy). The fp8 matmul:
f32 output 1e-4 of the largest value (exact products, f32 sums in
another order), bf16 output 1e-2 (a sum in another order can cross a
bf16 rounding, 3.9e-3 of a value).

The add-LN kernels: f32 1e-4 (sums in another order), bf16 2e-2 (such
a sum can cross one bf16 rounding of out or dx, 3.9e-3 of a value).

A Paddle Conv2D → BatchNorm2D → pool stack in f32 on the card against
the CPU (1e-4): the port's f32 convolutions run with cuDNN's TF32 off
for the call, whatever the global flag says.

The Hopper flash backward adds dQ with reduce-adds whose order between
blocks changes from run to run, and the Hopper LN-MLP backward sums db1
with atomics: the low bits of those outputs vary between runs, inside
the bf16 gradient tolerance below.

Tolerances: f32 1e-4 (f32 sums in another order, atomics in any order);
bf16 2e-2 on forward outputs (the plain versions round scores to bf16
where the kernels keep f32); lse 1e-3; bf16 gradients 2e-2 of the
largest value (same roundings at the same points, but an f32 sum in
another order can cross a bf16 rounding boundary).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_kernels as tfk
from paddle_tpu_torch.ops import fused_optimizer as tfo
from paddle_tpu_torch.amp import fp8 as tf8
from paddle_tpu_torch.ops import fp8_matmul as tfm
from paddle_tpu_torch.ops import int8_matmul as tim
from paddle_tpu_torch.ops import moe_dispatch as tmd
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.parallel import DistributedTrainStep
from paddle_tpu_torch.parallel.train_step import pure_adamw_init
from paddle_tpu_torch.serving import InferenceEngine, KVCache
from torch_port_util import cuda_device  # noqa: F401 (fixture)

pytestmark = pytest.mark.cuda


def _randn(shape, dtype, dev, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).to(dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,sk,d,causal", [(100, 100, 128, True),
                                            (16, 16, 64, True),
                                            (33, 97, 64, True),
                                            (70, 70, 128, False),
                                            (200, 333, 128, True),
                                            (130, 300, 64, False),
                                            (300, 130, 128, True),
                                            (257, 129, 64, True)])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, sq, sk, d,
                                    causal):
    """bf16 at D 64 and 128 runs the TMA/wgmma kernel: Sq != Sk with a
    ragged S at B·H = 8 puts tiles across the heads' boundaries of its 3D
    tensor maps; Sq > Sk causal has rows that see no key (uniform over
    every key, as in the plain version)."""
    q = _randn((2, 4, sq, d), dtype, cuda_device, 1)
    k = _randn((2, 4, sk, d), dtype, cuda_device, 2)
    v = _randn((2, 4, sk, d), dtype, cuda_device, 3)
    before = tfa.LAUNCHES
    o, lse = tfa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == before + 1
    o_ref, lse_ref = tfa._flash_forward_reference(q, k, v, causal,
                                                  1.0 / math.sqrt(d))
    assert o.dtype == dtype and lse.shape == (8, sq, 1)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,sk,d,causal", [(100, 100, 128, True),
                                            (64, 64, 64, True),
                                            (33, 97, 64, True),
                                            (97, 33, 128, True),
                                            (70, 70, 128, False),
                                            (40, 40, 16, True)])
def test_flash_backward_kernel_matches_plain(cuda_device, dtype, tol, sq,
                                             sk, d, causal):
    q = _randn((2, 3, sq, d), dtype, cuda_device, 11)
    k = _randn((2, 3, sk, d), dtype, cuda_device, 12)
    v = _randn((2, 3, sk, d), dtype, cuda_device, 13)
    do = _randn((2, 3, sq, d), dtype, cuda_device, 14)
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_attention_forward(q, k, v, causal=causal)
    before = tfa.BWD_LAUNCHES
    got = tfa._flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES == before + 1
    want = tfa._flash_backward_reference(q, k, v, o, lse, do, causal, scale)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= tol


# the Hopper (TMA + wgmma) backward: bf16 at D 64 and 128, causal and
# not, Sq != Sk both ways, lengths off its 128-row kv and 64-row q tiles,
# and B·H = 144 > 132 SMs so that the persistent grid's loop wraps
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (1, 2, 100, 612, 128, True), (1, 2, 612, 100, 128, True),
    (1, 2, 100, 612, 64, False), (1, 2, 612, 100, 64, True),
    (2, 3, 257, 257, 128, False), (2, 3, 200, 333, 64, True),
    (3, 48, 130, 130, 128, True), (3, 48, 70, 190, 64, False),
    (2, 2, 1, 300, 128, True), (1, 3, 2048, 2048, 128, True)])
def test_flash_backward_hopper_kernel_matches_plain(cuda_device, b, h, sq,
                                                    sk, d, causal):
    assert tfa.kernel_for(torch.bfloat16, d) == "wgmma"
    dt = torch.bfloat16
    q = _randn((b, h, sq, d), dt, cuda_device, 41)
    k = _randn((b, h, sk, d), dt, cuda_device, 42)
    v = _randn((b, h, sk, d), dt, cuda_device, 43)
    do = _randn((b, h, sq, d), dt, cuda_device, 44)
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_attention_forward(q, k, v, causal=causal)
    before = tfa.BWD_LAUNCHES
    got = tfa._flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES == before + 1
    want = tfa._flash_backward_reference(q, k, v, o, lse, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= 2e-2, name


def test_flash_autograd_on_card(cuda_device):
    """flash_attention_arrays is differentiable on a CUDA tensor: the
    backward kernel gives the gradient the plain forward's autograd
    gives (f32)."""
    q, k, v = (_randn((1, 2, 50, 64), torch.float32, cuda_device, s)
               .requires_grad_(True) for s in (21, 22, 23))
    before = (tfa.LAUNCHES, tfa.BWD_LAUNCHES)
    out = tfa.flash_attention_arrays(q, k, v, causal=True)
    out.square().sum().backward()
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES) == (before[0] + 1,
                                               before[1] + 1)
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    tfa.flash_attention_arrays(qc, kc, vc, causal=True).square().sum() \
        .backward()
    for t, c in zip((q, k, v), (qc, kc, vc)):
        assert _rel(t.grad.cpu(), c.grad) <= 1e-4


def _fmlp_inputs(R, H, M, dtype, dev, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n = lambda *s, sc=1.0: (torch.randn(s, generator=gen) * sc)
    t = {"x": n(R, H), "w1": n(H, M, sc=0.05), "b1": n(M, sc=0.1),
         "w2": n(M, H, sc=0.05), "b2": n(H, sc=0.1),
         "wg": n(H, M, sc=0.05), "bg": n(M, sc=0.1), "dy": n(R, H)}
    t = {k: v.to(dtype).to(dev) for k, v in t.items()}
    t["lns"] = (1.0 + n(H, sc=0.1)).to(dev)
    t["lnb"] = n(H, sc=0.1).to(dev)
    return t


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
@pytest.mark.parametrize("R,H,M", [(100, 128, 256), (64, 64, 128)])
def test_fused_mlp_kernels_match_plain(cuda_device, dtype, tol, act, R, H,
                                       M):
    t = _fmlp_inputs(R, H, M, dtype, cuda_device, 31)
    gate = act == "swiglu"
    wg, bg = (t["wg"], t["bg"]) if gate else (None, None)
    args = (t["x"], t["lns"], t["lnb"], t["w1"], t["b1"], t["w2"], t["b2"],
            wg, bg, act, True, True, 1e-5)
    f0 = tfk.FWD_LAUNCHES
    y, mu, rstd = tfk._fmlp_forward(*args)
    torch.cuda.synchronize()
    assert tfk.FWD_LAUNCHES == f0 + 1
    y_ref, mu_ref, rstd_ref = tfk._fmlp_forward_reference(*args)
    assert y.dtype == dtype and _rel(y, y_ref) <= tol
    assert _rel(mu, mu_ref) <= 1e-5 and _rel(rstd, rstd_ref) <= 1e-5
    bargs = (t["x"], t["lns"], t["lnb"], t["w1"], t["b1"], t["w2"], wg, bg,
             mu_ref, rstd_ref, t["dy"], act, True, True)
    b0 = (tfk.BWD_LAUNCHES, tfk.DW2_LAUNCHES)
    got = tfk._fmlp_backward(*bargs)
    torch.cuda.synchronize()
    assert (tfk.BWD_LAUNCHES, tfk.DW2_LAUNCHES) == (b0[0] + 1, b0[1] + 1)
    want = tfk._fmlp_backward_reference(*bargs)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2", "dwg",
             "dbg")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, name
        assert _rel(g, w) <= tol, name


# the Hopper (TMA + wgmma) backward GEMMs: ragged R (a partial last
# 64-deep step of the weight gradients and a partial row tile), H and M
# multiples of 64 but not of 128 (partial column tiles), every activation
@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
@pytest.mark.parametrize("R,H,M", [(100, 192, 320), (8191, 192, 320)])
def test_fused_mlp_hopper_backward_matches_plain(cuda_device, act, R, H, M):
    assert tfk.mlp_bwd_kernel_for(torch.bfloat16) == "wgmma"
    t = _fmlp_inputs(R, H, M, torch.bfloat16, cuda_device, 32)
    gate = act == "swiglu"
    wg, bg = (t["wg"], t["bg"]) if gate else (None, None)
    args = (t["x"], t["lns"], t["lnb"], t["w1"], t["b1"], t["w2"], t["b2"],
            wg, bg, act, True, True, 1e-5)
    _, mu, rstd = tfk._fmlp_forward_reference(*args)
    bargs = (t["x"], t["lns"], t["lnb"], t["w1"], t["b1"], t["w2"], wg, bg,
             mu, rstd, t["dy"], act, True, True)
    b0 = (tfk.BWD_LAUNCHES, tfk.DW2_LAUNCHES)
    got = tfk._fmlp_backward(*bargs)
    torch.cuda.synchronize()
    assert (tfk.BWD_LAUNCHES, tfk.DW2_LAUNCHES) == (b0[0] + 1, b0[1] + 1)
    want = tfk._fmlp_backward_reference(*bargs)
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2", "dwg",
             "dbg")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= 2e-2, name


# the Hopper (TMA + wgmma) forward GEMMs: ragged R (a partial row tile),
# H and M multiples of 64 but not of the 256- and 192-wide tiles (partial
# column tiles), every activation, with and without the residual and LN
@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
@pytest.mark.parametrize("R,H,M", [(100, 192, 320), (8191, 192, 320)])
@pytest.mark.parametrize("residual,has_ln", [(True, True), (False, True),
                                             (True, False)])
def test_fused_mlp_hopper_forward_matches_plain(cuda_device, act, R, H, M,
                                                residual, has_ln):
    assert tfk.mlp_fwd_kernel_for(torch.bfloat16) == "wgmma"
    t = _fmlp_inputs(R, H, M, torch.bfloat16, cuda_device, 34)
    if not has_ln:   # the plain version's identity LN, as fused_ln_mlp's
        t["lns"], t["lnb"] = torch.ones_like(t["lns"]), torch.zeros_like(
            t["lnb"])
    gate = act == "swiglu"
    wg, bg = (t["wg"], t["bg"]) if gate else (None, None)
    args = (t["x"], t["lns"], t["lnb"], t["w1"], t["b1"], t["w2"], t["b2"],
            wg, bg, act, residual, has_ln, 1e-5)
    f0 = tfk.FWD_LAUNCHES
    y, mu, rstd = tfk._fmlp_forward(*args)
    torch.cuda.synchronize()
    assert tfk.FWD_LAUNCHES == f0 + 1
    y_ref, mu_ref, rstd_ref = tfk._fmlp_forward_reference(*args)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    assert _rel(y, y_ref) <= 2e-2
    assert _rel(mu, mu_ref) <= 1e-5 and _rel(rstd, rstd_ref) <= 1e-5


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_fused_mlp_hopper_forward_copies_unaligned_operands(cuda_device,
                                                             act):
    """x, the weights and the biases as views off a 16-byte boundary:
    the forward wrapper copies them for the tensor maps and the paired
    reads, and y is that of the aligned tensors."""
    t = _fmlp_inputs(100, 192, 320, torch.bfloat16, cuda_device, 35)

    def unaligned(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        assert out.data_ptr() % 16 != 0
        return out

    gate = act == "swiglu"
    u = {k: unaligned(t[k]) for k in ("x", "w1", "b1", "w2", "b2", "wg",
                                      "bg")}

    def args(d):
        wg, bg = (d["wg"], d["bg"]) if gate else (None, None)
        return (d["x"], t["lns"], t["lnb"], d["w1"], d["b1"], d["w2"],
                d["b2"], wg, bg, act, True, True, 1e-5)

    y = tfk._fmlp_forward(*args(u))[0]
    y_ref = tfk._fmlp_forward_reference(*args(t))[0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and _rel(y, y_ref) <= 2e-2


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_fused_mlp_hopper_backward_copies_unaligned_operands(cuda_device,
                                                              act):
    """x, dy, the weights and the biases as views off a 16-byte boundary:
    the wrapper copies them for the tensor maps and the paired bias
    reads, and the grads are those of the aligned tensors."""
    t = _fmlp_inputs(100, 192, 320, torch.bfloat16, cuda_device, 33)

    def unaligned(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        assert out.data_ptr() % 16 != 0
        return out

    gate = act == "swiglu"
    names = ("x", "w1", "b1", "w2", "wg", "bg", "dy")
    u = {k: unaligned(t[k]) for k in names}

    def bargs(d):
        wg, bg = (d["wg"], d["bg"]) if gate else (None, None)
        _, mu, rstd = tfk._fmlp_forward_reference(
            d["x"], t["lns"], t["lnb"], d["w1"], d["b1"], d["w2"], t["b2"],
            wg, bg, act, True, True, 1e-5)
        return (d["x"], t["lns"], t["lnb"], d["w1"], d["b1"], d["w2"], wg,
                bg, mu, rstd, d["dy"], act, True, True)

    got = tfk._fmlp_backward(*bargs(u))
    want = tfk._fmlp_backward_reference(*bargs(t))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert bool(torch.isfinite(g).all()) and _rel(g, w) <= 2e-2


def test_fused_mlp_refuses_untileable_widths(cuda_device):
    x = torch.zeros(4, 96, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 64"):
        tfk.fused_ln_mlp(x, torch.zeros(96, 256, device=cuda_device),
                         torch.zeros(256, device=cuda_device),
                         torch.zeros(256, 96, device=cuda_device),
                         torch.zeros(96, device=cuda_device))


def test_train_step_on_card_matches_cpu(cuda_device):
    """A small fused, remat'd GPT (f32, head_dim 64) on the card (the
    kernels) and on the CPU (the plain versions): the loss and every
    gradient agree, and two AdamW steps give the same losses. Gradient
    tolerance, of each leaf's largest value: both heads round the
    logits' operands and their cotangents to bf16, so a last-bit
    difference upstream can flip one such rounding, 3.9e-3 of one
    element of the tied embedding's gradient (5e-3) and less of every
    other leaf's (2e-3)."""
    cfg = tg.GPTConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=2,
                       seq_len=64, dtype=torch.float32, remat=True,
                       fused_mlp=True)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.integers(0, 512, (2, 64))),
             torch.from_numpy(rng.integers(0, 512, (2, 64))))
    loss_fn = lambda p, b: tg.gpt_loss(cfg, p, b, loss_chunk=16)

    def grads(device):
        p = {k: ({kk: vv.to(device).requires_grad_(True)
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(device).requires_grad_(True))
             for k, v in params.items()}
        loss = loss_fn(p, tuple(t.to(device) for t in batch))
        loss.backward()
        return float(loss.detach()), p

    before = (tfa.BWD_LAUNCHES, tfk.FWD_LAUNCHES, tfk.BWD_LAUNCHES,
              tfk.DW2_LAUNCHES)
    l_card, p_card = grads(cuda_device)
    after = (tfa.BWD_LAUNCHES, tfk.FWD_LAUNCHES, tfk.BWD_LAUNCHES,
             tfk.DW2_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))
    l_cpu, p_cpu = grads("cpu")
    assert abs(l_card - l_cpu) <= 1e-4
    leaves = [(k, p_card[k], p_cpu[k]) for k in ("wte", "wpe", "lnf_s",
                                                 "lnf_b")]
    leaves += [(k, p_card["blocks"][k], v) for k, v in
               p_cpu["blocks"].items()]
    rel = {k: _rel(c.grad.cpu(), w.grad) for k, c, w in leaves}
    assert all(r <= (5e-3 if k == "wte" else 2e-3) for k, r in rel.items()), \
        rel

    def run(device):
        step = DistributedTrainStep(loss_fn, params, lr=1e-3, device=device)
        return [float(step(batch)) for _ in range(2)]

    np.testing.assert_allclose(run(cuda_device), run("cpu"), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_kernel_matches_plain(cuda_device, dtype, tol, hd):
    B, nh, bs, W, L, layer = 4, 8, 16, 6, 3, 1
    nb = 1 + B * W
    kb = _randn((nb, L, nh, bs, hd), dtype, cuda_device, 5)
    vb = _randn((nb, L, nh, bs, hd), dtype, cuda_device, 6)
    q = _randn((B, nh, hd), dtype, cuda_device, 7)
    tables = torch.zeros((B, W), dtype=torch.int32)
    tables[0, :5] = torch.tensor([3, 9, 1, 12, 20])
    tables[1, :2] = torch.tensor([4, 2])
    tables[2, :1] = torch.tensor([7])   # lane 3: all sink, stale length
    lengths = torch.tensor([70, 17, 1, 33], dtype=torch.int32)
    tables, lengths = tables.to(cuda_device), lengths.to(cuda_device)
    before = tpa.LAUNCHES
    got = tpa.paged_attention_arrays(q, kb, vb, tables, lengths,
                                     ragged=False, layer=layer)
    again = tpa.paged_attention_arrays(q, kb, vb, tables, lengths,
                                       ragged=True, layer=layer)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 2
    assert torch.equal(got, again)
    want = tpa._paged_attention_reference(q, kb[:, layer], vb[:, layer],
                                          tables, lengths, 1.0 / hd ** 0.5)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("poison", ["all", "one_block"])
def test_paged_kernel_keeps_one_lanes_nan(cuda_device, dtype, hd, poison):
    """The serving watchdog's premise on the paged path: NaN K/V in one
    lane's blocks (all of them, or one) make that lane's output
    non-finite, as the plain version's softmax does, and leave every
    other lane bit-identical to the clean call's."""
    B, nh, bs, W, L, layer = 4, 8, 16, 6, 3, 1
    nb = 1 + B * W
    kb = _randn((nb, L, nh, bs, hd), dtype, cuda_device, 5)
    vb = _randn((nb, L, nh, bs, hd), dtype, cuda_device, 6)
    q = _randn((B, nh, hd), dtype, cuda_device, 7)
    tables = torch.zeros((B, W), dtype=torch.int32)
    tables[0, :5] = torch.tensor([3, 9, 1, 12, 20])
    tables[1, :2] = torch.tensor([4, 2])
    tables[2, :1] = torch.tensor([7])
    lengths = torch.tensor([70, 17, 1, 33], dtype=torch.int32)
    tables, lengths = tables.to(cuda_device), lengths.to(cuda_device)
    clean = tpa.paged_attention_arrays(q, kb, vb, tables, lengths,
                                       layer=layer)
    bad = [3, 9, 1, 12, 20] if poison == "all" else [12]
    kb2, vb2 = kb.clone(), vb.clone()
    kb2[bad] = float("nan")
    vb2[bad] = float("nan")
    got = tpa.paged_attention_arrays(q, kb2, vb2, tables, lengths,
                                     layer=layer)
    want = tpa._paged_attention_reference(q, kb2[:, layer], vb2[:, layer],
                                          tables, lengths, 1.0 / hd ** 0.5)
    torch.cuda.synchronize()
    assert not torch.isfinite(want[0]).any()
    assert not torch.isfinite(got[0]).any()
    assert torch.equal(got[1:], clean[1:])


def test_int8_quantizer_keeps_a_nan_row_in_its_row(cuda_device):
    """The serving watchdog's premise on the int8 decode path: with one
    NaN or inf row of activations (the poisoned slot of an int8 tick)
    the quantizing kernel leaves the NaN or inf out of the per-tensor
    abs-max and gives that row a NaN scale, so its output row is NaN and
    every other row equals the call with its non-finite entries zeroed;
    the plain version does the same (the JAX package's per-tensor scale
    would turn every row NaN)."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    M, K, N, r = 8, 2048, 384, 5
    x = (torch.randn(M, K, generator=gen) * 3).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8)
    ws = torch.rand(N, generator=gen) * 0.02 + 1e-4
    x, wq, ws = x.to(cuda_device), wq.to(cuda_device), ws.to(cuda_device)
    xn = x.clone()
    xn[r] = float("nan")
    xp = x.clone()
    xp[r, ::7] = float("nan")            # a row only partly NaN
    xi = x.clone()
    xi[r, 3] = float("inf")              # one inf: an inf V's output
    xi[r, 9] = -float("inf")
    keep = [i for i in range(M) if i != r]
    for xx in (xn, xp, xi):
        got = tim.dynamic_int8_matmul(xx, wq, ws)
        plain = tim._dynamic_int8_reference(xx, wq, ws)
        zeroed = tim.dynamic_int8_matmul(
            torch.nan_to_num(xx, nan=0.0, posinf=0.0, neginf=0.0), wq, ws)
        torch.cuda.synchronize()
        assert not torch.isfinite(got[r]).any()
        assert not torch.isfinite(plain[r]).any()
        assert torch.isfinite(got[keep]).all()
        assert torch.equal(got[keep], plain[keep])
        assert torch.equal(got[keep], zeroed[keep])


def _paged_edge_case(B, nh, hd, bs, W, L, dtype, dev, seed):
    """Slots whose live blocks are 1, the cluster's size (8), one past it
    and the whole table (W = 11, no multiple of 8), a slot of length 0 and
    a stale lane (an all-sink table with a leftover length)."""
    assert tpa.cluster_size(B, nh, W) == 8
    nb = 1 + 4 * W
    kb = _randn((nb, L, nh, bs, hd), dtype, dev, seed)
    vb = _randn((nb, L, nh, bs, hd), dtype, dev, seed + 1)
    q = _randn((B, nh, hd), dtype, dev, seed + 2)
    gen = torch.Generator(device="cpu").manual_seed(seed + 3)
    perm = torch.randperm(nb - 1, generator=gen).int() + 1
    lengths = [bs - 3, 8 * bs, 8 * bs + 1, W * bs - 5, 0, 2 * bs + 1]
    tables = torch.zeros((B, W), dtype=torch.int32)
    used = 0
    for b, n in enumerate((1, 8, 9, W)):
        tables[b, :n] = perm[used:used + n]
        used += n
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return q, kb, vb, tables.to(dev), lengths.to(dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_kernel_edge_lengths_match_plain(cuda_device, dtype, tol, hd,
                                               bs):
    """Every (hd, bs) pair at the edge lengths; length 0 gives zeros (the
    plain version's uniform average is not the contract there)."""
    B, nh, W, L, layer = 6, 4, 11, 2, 1
    q, kb, vb, tables, lengths = _paged_edge_case(B, nh, hd, bs, W, L,
                                                  dtype, cuda_device, 40)
    got = tpa.paged_attention_arrays(q, kb, vb, tables, lengths,
                                     ragged=False, layer=layer)
    again = tpa.paged_attention_arrays(q, kb, vb, tables, lengths,
                                       ragged=True, layer=layer)
    want = tpa._paged_attention_reference(q, kb[:, layer], vb[:, layer],
                                          tables, lengths, 1.0 / hd ** 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert not got[4].any()
    live = [0, 1, 2, 3, 5]
    assert (got[live].float() - want[live].float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_long_and_short_slots_match_plain(cuda_device, dtype,
                                                       tol):
    """Phase 4's batch of chip_smoke.py at one layer: long slots split
    over a full cluster, short ones leaving most of theirs idle; repeated
    calls agree bit for bit."""
    B, nh, hd, bs, W = 8, 16, 128, 16, 128
    lengths = torch.tensor([2047, 1500, 700, 129, 17, 1, 33, 1],
                           dtype=torch.int32)
    n_live = [-(-int(n) // bs) for n in lengths]
    nb = 1 + sum(n_live[:6])
    kb = _randn((nb, 1, nh, bs, hd), dtype, cuda_device, 70)
    vb = _randn((nb, 1, nh, bs, hd), dtype, cuda_device, 71)
    q = _randn((B, nh, hd), dtype, cuda_device, 72)
    gen = torch.Generator(device="cpu").manual_seed(73)
    perm = torch.randperm(nb - 1, generator=gen).int() + 1
    tables = torch.zeros((B, W), dtype=torch.int32)
    used = 0
    for b in range(6):              # lanes 6, 7: all sink, stale lengths
        tables[b, :n_live[b]] = perm[used:used + n_live[b]]
        used += n_live[b]
    tables, lengths = tables.to(cuda_device), lengths.to(cuda_device)
    got = tpa.paged_attention_arrays(q, kb, vb, tables, lengths, layer=0)
    again = tpa.paged_attention_arrays(q, kb, vb, tables, lengths, layer=0)
    want = tpa._paged_attention_reference(q, kb[:, 0], vb[:, 0], tables,
                                          lengths, 1.0 / hd ** 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_unaligned_pool_takes_element_copies(cuda_device,
                                                          dtype):
    """A pool view whose base is not 16-byte aligned cannot take bulk
    copies: the element path gives the same bits as the aligned pool."""
    B, nh, hd, bs, W, L, layer = 6, 4, 64, 16, 11, 2, 0
    q, kb, vb, tables, lengths = _paged_edge_case(B, nh, hd, bs, W, L,
                                                  dtype, cuda_device, 50)
    n = kb.numel()
    kbuf = torch.empty(n + 1, dtype=dtype, device=cuda_device)
    vbuf = torch.empty(n + 1, dtype=dtype, device=cuda_device)
    ku, vu = kbuf[1:].view(kb.shape), vbuf[1:].view(vb.shape)
    ku.copy_(kb)
    vu.copy_(vb)
    assert ku.data_ptr() % 16 and ku.is_contiguous()
    got = tpa.paged_attention_arrays(q, ku, vu, tables, lengths, layer=layer)
    want = tpa.paged_attention_arrays(q, kb, vb, tables, lengths,
                                      layer=layer)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_paged_kernel_is_one_launch_a_call(cuda_device):
    """One kernel on the card per call (the split keys merge inside the
    launch), and the wrapper counts it once."""
    B, nh, hd, bs, W, L = 6, 4, 128, 16, 11, 2
    q, kb, vb, tables, lengths = _paged_edge_case(
        B, nh, hd, bs, W, L, torch.bfloat16, cuda_device, 60)
    tpa.paged_attention_arrays(q, kb, vb, tables, lengths, layer=1)
    torch.cuda.synchronize()
    before = tpa.LAUNCHES
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            tpa.paged_attention_arrays(q, kb, vb, tables, lengths, layer=1)
        torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:                # the trace may lose device events
        assert len(kernels) == 3
        assert all("paged_decode" in e.name for e in kernels)


def _small_engine_model():
    cfg = tg.GPTConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=2,
                       seq_len=128, dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
        params["blocks"][k] *= 4.0
    return cfg, params


def test_engine_on_card_matches_cpu(cuda_device):
    """Both cache modes on the card (flash prefill in fixed mode, paged
    decode in paged mode) give the CPU engine's greedy tokens (f32,
    head_dim 64, block matrices scaled so tokens vary)."""
    cfg, params = _small_engine_model()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77)]

    def run(paged, device):
        eng = InferenceEngine(cfg, params, n_slots=2, paged=paged,
                              device=device)
        try:
            return [eng.generate(p, max_new_tokens=12) for p in prompts]
        finally:
            eng.shutdown()

    want = run(False, "cpu")
    f0, p0 = tfa.LAUNCHES, tpa.LAUNCHES
    assert run(False, cuda_device) == want
    assert tfa.LAUNCHES > f0
    assert run(True, cuda_device) == want
    assert tpa.LAUNCHES > p0


def test_router_failover_on_card(cuda_device, monkeypatch):
    """Two paged replicas on the card under an EngineRouter; replica 0
    is crashed by ``fail_at_tick`` once its streams decode: every stream
    ends on the survivor, equal to the same router's undisturbed card run
    (f32), and the paged decode kernel launched on both replicas'
    scheduler threads."""
    import threading
    import time

    from paddle_tpu_torch.serving import EngineRouter

    cfg, params = _small_engine_model()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77, 21)]
    threads = {}
    launch = tpa._launch

    def counted(*args, **kw):
        key = threading.get_ident()
        threads[key] = threads.get(key, 0) + 1
        return launch(*args, **kw)

    monkeypatch.setattr(tpa, "_launch", counted)

    def run(crash):
        engines = [InferenceEngine(cfg, params, n_slots=2, paged=True,
                                   device=cuda_device) for _ in range(2)]
        router = EngineRouter(engines)
        try:
            reqs = [router.submit(p, max_new_tokens=16) for p in prompts]
            on0 = [r for r in reqs if r._replica == 0]
            if crash:
                deadline = time.monotonic() + 300
                while not all(len(r.tokens) >= 2 for r in on0):
                    assert time.monotonic() < deadline, "no decode on 0"
                    time.sleep(0.001)
                engines[0].fail_at_tick(1)
            return ([r.result(timeout=300) for r in reqs], reqs,
                    router.healthy_replicas(),
                    [e._thread.ident for e in engines])
        finally:
            router.shutdown(drain=False, timeout=60)

    want = run(False)[0]
    threads.clear()
    p0 = tpa.LAUNCHES
    got, reqs, healthy, idents = run(True)
    assert got == want
    assert all(r.finish_reason == "length" and r._replica == 1
               for r in reqs)
    assert healthy == [1]
    assert tpa.LAUNCHES - p0 == sum(threads.values())
    assert all(threads.get(i, 0) > 0 for i in idents)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_on_card_matches_non_spec(cuda_device, paged):
    """A speculative engine on the card (a 1-layer gpt_truncate draft,
    spec_k 3; flash prefill of both models in fixed mode, the composed
    verify on every tick) gives the CPU non-speculative engine's greedy
    tokens (f32), and sampled streams replay exactly."""
    from paddle_tpu_torch.monitor.stats import stat_get

    cfg, params = _small_engine_model()
    draft = tg.gpt_truncate(cfg, params, 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77)]

    def run(device, spec, **kw):
        eng = InferenceEngine(cfg, params, n_slots=2, paged=paged,
                              device=device, seed=3,
                              draft=draft if spec else None, spec_k=3)
        try:
            return [eng.generate(p, max_new_tokens=12, **kw)
                    for p in prompts]
        finally:
            eng.shutdown()

    a0 = stat_get("spec_accepted")
    assert run(cuda_device, True) == run("cpu", False)
    assert stat_get("spec_accepted") > a0
    sampled = dict(temperature=0.8, top_k=20)
    assert run(cuda_device, True, **sampled) \
        == run(cuda_device, True, **sampled)


def test_prefix_engine_on_card_matches_cold(cuda_device):
    """The prefix cache on the card: shared-head prompts, copy-on-write
    of a partly used block, a pool small enough to evict tree leaves:
    greedy tokens equal the CPU cold engine's (f32), and after shutdown
    every refcount is the tree's own."""
    from paddle_tpu_torch.monitor.stats import stat_get

    cfg, params = _small_engine_model()
    rng = np.random.default_rng(2)
    head = rng.integers(0, 512, 37)
    prompts = [np.concatenate([head, rng.integers(0, 512, 9)])
               for _ in range(3)]
    prompts += prompts + [rng.integers(0, 512, 60) for _ in range(3)]

    def run(device, prefix):
        eng = InferenceEngine(cfg, params, n_slots=2, paged=True,
                              device=device, block_size=16, n_blocks=14,
                              prefill_chunk=32, prefix_cache=prefix)
        try:
            return eng, [eng.generate(p, max_new_tokens=12)
                         for p in prompts]
        finally:
            eng.shutdown()

    c0, e0 = stat_get("prefix_cow_copies"), stat_get("prefix_evictions")
    p0 = tpa.LAUNCHES
    eng, got = run(cuda_device, True)
    assert got == run("cpu", False)[1]
    assert tpa.LAUNCHES > p0
    assert stat_get("prefix_cow_copies") > c0
    assert stat_get("prefix_evictions") > e0
    blocks = eng._prefix.blocks()
    assert eng.cache._refs == {b: 1 for b in blocks}


def _opt_leaves(pdt, mdt, dev, seed):
    """A bucket of ragged leaves, one of them an unaligned view (the
    kernel's scalar path)."""
    sizes = (1, 3, 1000, 4099, 20000)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda n, sc, dt: (torch.randn(n, generator=gen) * sc).to(dt).to(dev)
    ps = [mk(n, 1.0, pdt) for n in sizes]
    ps.append(mk(1001, 1.0, pdt)[1:])          # offset by one element
    gs = [mk(p.numel(), 0.1, pdt) for p in ps]
    ms = [mk(p.numel(), 0.01, mdt) for p in ps]
    vs = [mk(p.numel(), 1e-3, mdt).abs() for p in ps]
    return ps, gs, ms, vs


@pytest.mark.parametrize("pdt,mdt,l2,eager", [
    (torch.float32, torch.float32, 0.0, False),
    (torch.float32, torch.bfloat16, 0.01, False),
    (torch.bfloat16, torch.float32, 0.0, True),
    (torch.bfloat16, torch.bfloat16, 0.01, True)])
def test_fused_adamw_kernel_matches_plain(cuda_device, pdt, mdt, l2, eager):
    ps, gs, ms, vs = _opt_leaves(pdt, mdt, cuda_device, 21)
    sc = torch.tensor([3e-3, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                      device=cuda_device)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.05, l2=l2, eager_form=eager)
    want = [tfo._adamw_flat_reference(p, g, m, v, sc[0], sc[1], sc[2], **kw)
            for p, g, m, v in zip(ps, gs, ms, vs)]
    before = tfo.ADAMW_LAUNCHES
    tfo._bucket_adamw(ps, gs, ms, vs, sc, **kw)
    torch.cuda.synchronize()
    assert tfo.ADAMW_LAUNCHES == before + 1        # one launch per bucket
    for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
        assert torch.equal(p, wp) and torch.equal(m, wm) \
            and torch.equal(v, wv)


@pytest.mark.parametrize("pdt,mdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_fused_lamb_kernel_matches_plain(cuda_device, pdt, mdt):
    ps, gs, ms, vs = _opt_leaves(pdt, mdt, cuda_device, 22)
    sc = torch.tensor([0.0, 1 - 0.9 ** 2, 1 - 0.999 ** 2],
                      device=cuda_device)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    want = [tfo._lamb_flat_reference(p, g, m, v, sc[1], sc[2], **kw)
            for p, g, m, v in zip(ps, gs, ms, vs)]
    old = tfo._R_CAP
    try:
        tfo._R_CAP = 5000            # groups of leaves share one r buffer
        before = tfo.LAMB_LAUNCHES
        got = {}
        for idx, rs in tfo._bucket_lamb(ps, gs, ms, vs, sc, **kw):
            got.update({i: r.clone() for i, r in zip(idx, rs)})
        torch.cuda.synchronize()
        assert tfo.LAMB_LAUNCHES - before == len(tfo._lamb_groups(ps)[0]) > 1
    finally:
        tfo._R_CAP = old
    for i, (wm, wv, wr) in enumerate(want):
        assert torch.equal(ms[i], wm) and torch.equal(vs[i], wv)
        assert torch.equal(got[i], wr)


def test_fused_updates_on_card_match_cpu(cuda_device):
    """fused_adamw_update / fused_lamb_update on the card (kernels) and
    the CPU (plain versions): 3 steps of a small tree, params to 1e-6."""
    gen = torch.Generator(device="cpu").manual_seed(23)
    tree = {"w": torch.randn(64, 48, generator=gen),
            "blk": {"b": torch.randn(48, generator=gen)}}
    grads = [{"w": torch.randn(64, 48, generator=gen) * 0.1,
              "blk": {"b": torch.randn(48, generator=gen) * 0.1}}
             for _ in range(3)]
    mv = lambda t, d: {k: mv(v, d) if isinstance(v, dict) else v.to(d)
                       for k, v in t.items()}
    for upd in (tfo.fused_adamw_update, tfo.fused_lamb_update):
        out = {}
        for dev in (cuda_device, "cpu"):
            p = mv(tree, dev)
            st = pure_adamw_init(p)
            for g in grads:
                upd(p, mv(g, dev), st, 1e-2, weight_decay=0.1)
            out[str(torch.device(dev).type)] = mv(p, "cpu")
        assert _rel(out["cuda"]["w"], out["cpu"]["w"]) <= 1e-6
        assert _rel(out["cuda"]["blk"]["b"], out["cpu"]["blk"]["b"]) <= 1e-6


@pytest.mark.parametrize("M,K,N,per_row,bias,out", [
    (8, 256, 384, False, False, torch.float32),
    (1, 2048, 2048, False, False, torch.bfloat16),
    (100, 64, 192, False, True, torch.float32),
    (3, 50, 37, True, True, torch.bfloat16),
    (9, 130, 20, True, False, torch.float32),
    (17, 4100, 40, False, True, torch.bfloat16),
    (2, 33000, 48, True, False, torch.float32)])
def test_int8_kernel_matches_plain(cuda_device, M, K, N, per_row, bias, out):
    gen = torch.Generator(device="cpu").manual_seed(M * K)
    xq = torch.randint(-127, 128, (M, K), generator=gen,
                       dtype=torch.int8).to(cuda_device)
    wq = torch.randint(-127, 128, (K, N), generator=gen,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(N, generator=gen) * 0.02 + 1e-4).to(cuda_device)
    xs = (torch.rand((M, 1) if per_row else (), generator=gen) * 0.05
          + 1e-3).to(cuda_device)
    b = torch.randn(N, generator=gen).to(cuda_device) if bias else None
    before = tim.LAUNCHES
    got = tim.int8_matmul_arrays(xq, wq, ws, xs, bias=b, out_dtype=out)
    torch.cuda.synchronize()
    assert tim.LAUNCHES == before + 1
    want = tim._int8_matmul_reference(xq, wq, ws, xs, b, out)
    assert got.dtype == out and torch.equal(got, want)
    # the int32 sum itself, checked on the CPU
    acc = (xq.cpu().int() @ wq.cpu().int()).double()
    assert torch.equal((xq.double() @ wq.double()).cpu(), acc)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["random", "zeros", "halves"])
@pytest.mark.parametrize("M,K,N,bias", [
    (8, 2048, 384, False), (1, 256, 128, True), (3, 50, 37, True),
    (17, 4100, 40, False), (2, 33000, 48, True)])
def test_int8_fused_quantization_matches_plain(cuda_device, xdt, case, M,
                                               K, N, bias):
    """dynamic_int8_matmul on the card quantizes the activations in a
    launch of its own before the product's: bit-identical to its plain version (the abs-max scale
    with its 1e-8 floor, true division, round half to even, clip, then
    the product) for both activation dtypes, with and without a bias,
    ragged shapes, M > 8 (row groups) and K past one pass."""
    gen = torch.Generator(device="cpu").manual_seed(M * K + N)
    if case == "zeros":
        x = torch.zeros(M, K)
    elif case == "halves":
        x = torch.randint(-126, 126, (M, K), generator=gen) + 0.5
        x[0, 0] = -127.0
    else:
        x = torch.randn(M, K, generator=gen) * 3
    x = x.to(xdt).to(cuda_device)
    wq = torch.randint(-127, 128, (K, N), generator=gen,
                       dtype=torch.int8).to(cuda_device)
    ws = (torch.rand(N, generator=gen) * 0.02 + 1e-4).to(cuda_device)
    b = torch.randn(N, generator=gen).to(cuda_device) if bias else None
    before = tim.LAUNCHES
    got = tim.dynamic_int8_matmul(x, wq, ws, b)
    torch.cuda.synchronize()
    assert tim.LAUNCHES == before + 2       # the quantizing kernel, the product
    want = tim._dynamic_int8_reference(x, wq, ws, b)
    assert got.dtype == xdt and torch.equal(got, want)


def test_int8_decode_on_card_matches_cpu(cuda_device):
    """One int8 decode step (f32, head_dim 64) with the kernels on the
    card and the plain versions on the CPU. The activations agree up to
    f32 summation order, which can move one quantized activation by one
    step: logits within 1e-2 of the largest."""
    cfg = tg.GPTConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=2,
                       seq_len=64, dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=1, device="cpu")
    q = tg.quantize_gpt_weights(params)
    pos = torch.tensor([0, 5, 9], dtype=torch.int32)
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)

    def run(dev):
        qd = {k: ({kk: ({a: b.to(dev) for a, b in vv.items()}
                        if isinstance(vv, dict) else vv.to(dev))
                   for kk, vv in v.items()} if isinstance(v, dict)
                  else v.to(dev)) for k, v in q.items()}
        c = KVCache(cfg, n_slots=3, device=dev)
        with torch.inference_mode():
            lg, _ = tg.gpt_decode_step(cfg, qd, (c.k, c.v), pos.to(dev),
                                       tok.to(dev))
        return lg.cpu()

    before = tim.LAUNCHES
    card = run(cuda_device)
    # 4 weight-only matmuls a layer, each a quantizing launch and a product
    assert tim.LAUNCHES == before + 2 * 4 * cfg.n_layers
    assert _rel(card, run("cpu")) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,N,H", [(8, 64, 2048), (50, 96, 64),
                                   (100, 300, 100), (7, 13, 3)])
def test_moe_gather_kernel_matches_plain(cuda_device, dtype, T, N, H):
    x = _randn((T, H), dtype, cuda_device, 31)
    gen = torch.Generator(device="cpu").manual_seed(T * N)
    src = torch.randint(-1, T, (N,), generator=gen, dtype=torch.int32)
    src[:2] = -1
    src = src.to(cuda_device)
    before = tmd.LAUNCHES
    got = tmd.moe_dispatch_gather(x, src)
    torch.cuda.synchronize()
    assert tmd.LAUNCHES == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, tmd._gather_reference(x, src))
    assert not got[:2].any()


def test_moe_gather_kernel_edge_cases(cuda_device):
    """N 0 launches nothing; an all-empty src gives zeros; src >= T
    gives zeros (the plain version refuses it)."""
    x = _randn((16, 256), torch.bfloat16, cuda_device, 32)
    before = tmd.LAUNCHES
    got = tmd.moe_dispatch_gather(
        x, torch.zeros(0, dtype=torch.int32, device=cuda_device))
    assert got.shape == (0, 256) and tmd.LAUNCHES == before
    empty = torch.full((37,), -1, dtype=torch.int32, device=cuda_device)
    got = tmd.moe_dispatch_gather(x, empty)
    torch.cuda.synchronize()
    assert tmd.LAUNCHES == before + 1
    assert got.shape == (37, 256) and not got.any()
    src = torch.tensor([3, 16, -1, 99, 15, 0, 2 ** 30], dtype=torch.int32,
                       device=cuda_device)
    got = tmd.moe_dispatch_gather(x, src)
    want = tmd._gather_reference(x, torch.where(src < 16, src, -1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[[1, 2, 3, 6]].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,N,H,offset", [
    (100, 1001, 100, 0),       # bf16 200-byte rows: 2-byte units
    (64, 333, 7, 0),           # 14- / 28-byte rows: 2-byte units
    (50, 257, 2056, 0),        # 16-byte vectors, rows past 4 KB
    (30, 99, 4096, 0),         # 16-byte vectors, 8 or 16 KB rows
    (40, 1001, 2048, 1)])      # an unaligned x: 2-byte units
def test_moe_gather_kernel_rows_and_runs(cuda_device, dtype, T, N, H,
                                         offset):
    """16-byte and 2-byte copies, N no multiple of a block's rows:
    bit-identical to the plain version."""
    base = _randn((T * H + offset,), dtype, cuda_device, 33)
    x = base[offset:].view(T, H)
    gen = torch.Generator(device="cpu").manual_seed(N + H)
    src = torch.randint(-1, T, (N,), generator=gen, dtype=torch.int32)
    src = src.to(cuda_device)
    got = tmd.moe_dispatch_gather(x, src)
    torch.cuda.synchronize()
    assert torch.equal(got, tmd._gather_reference(x, src))


def test_moe_gather_backward_on_card_matches_cpu(cuda_device):
    """The transpose scatter-add (index_add_) on the card: each token fills
    two slots, so each row's sum rounds once in any order."""
    T, N, H = 40, 96, 64
    gen = torch.Generator(device="cpu").manual_seed(5)
    src = torch.cat([torch.randperm(T, generator=gen),
                     torch.randperm(T, generator=gen),
                     torch.full((N - 2 * T,), -1)]).int()
    src = src[torch.randperm(N, generator=gen)]
    x = torch.randn((T, H), generator=gen).to(torch.bfloat16)
    dy = torch.randn((N, H), generator=gen).to(torch.bfloat16)

    def grad(dev):
        xs = x.to(dev).requires_grad_(True)
        out = tmd.moe_dispatch_gather(xs, src.to(dev))
        return torch.autograd.grad(out, xs, dy.to(dev))[0].cpu()

    assert torch.equal(grad(cuda_device), grad("cpu"))


@pytest.mark.parametrize("out,tol", [(torch.float32, 1e-4),
                                     (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("M,K,N,bias", [(100, 64, 192, True),
                                        (256, 512, 384, False),
                                        (1, 2048, 128, False),
                                        (130, 96, 130, True),
                                        (37, 40, 24, True),
                                        (40, 8192, 72, False),
                                        (100, 100, 192, True)])
@pytest.mark.parametrize("layout", ["row", "col"])
def test_fp8_kernel_matches_plain(cuda_device, out, tol, M, K, N, bias,
                                  layout):
    """Both weight layouts (a column-major wq is read in place, a
    row-major one transposed first); K = 8192 at small M and N holds the
    f32 sum over 64 pipeline stages of 128 k; K = 100 is zero-padded to
    112."""
    x = _randn((M, K), torch.float32, cuda_device, 41)
    w = _randn((K, N), torch.float32, cuda_device, 42) * 0.05
    b = _randn((N,), torch.float32, cuda_device, 43) if bias else None
    sx, sw = tf8._jit_scale(x), tf8._jit_scale(w)
    xq = tf8.quantize_fp8(x, sx)
    wq = tf8.quantize_fp8(w, sw) if layout == "row" \
        else tf8.quantize_fp8(w, sw, k_major=True)
    before = tfm.LAUNCHES
    got = tfm.fp8_matmul_arrays(xq, wq, sx, sw, b, out_dtype=out)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES == before + 1
    want = tfm._fp8_matmul_ref(xq, wq, sx, sw, b, out)
    assert got.dtype == out and got.shape == (M, N)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= tol


def test_fp8_linear_grads_on_card_match_cpu(cuda_device):
    """fp8_linear's forward (the kernel) and STE backward (bf16 GEMMs with
    f32 output on the card, f32 matmuls of the bf16 operands on the CPU):
    the same quantized codes, sums in another order."""
    x = _randn((64, 256), torch.bfloat16, "cpu", 44)
    w = (_randn((256, 192), torch.float32, "cpu", 45) * 0.05).to(
        torch.bfloat16)
    dy = _randn((64, 192), torch.bfloat16, "cpu", 46)

    def run(dev):
        xs, ws = (t.to(dev).requires_grad_(True) for t in (x, w))
        y = tf8.fp8_linear(xs, ws)
        gx, gw = torch.autograd.grad(y, (xs, ws), dy.to(dev))
        return y.cpu(), gx.cpu(), gw.cpu()

    before = tfm.LAUNCHES
    card = run(cuda_device)
    assert tfm.LAUNCHES == before + 1
    for c, w_ in zip(card, run("cpu")):
        assert c.dtype == torch.bfloat16
        assert _rel(c, w_) <= 1e-2


def test_moe_fp8_engine_and_loss_on_card_match_cpu(cuda_device):
    """A small MoE GPT with fp8 dense MLPs (f32, head_dim 64, matrices
    scaled so tokens vary): greedy streams on the card (the gather, fp8,
    flash and paged kernels) equal the CPU's in each cache mode (the two
    modes differ from each other: only the fixed-slot prefill runs the
    fp8 MLP, the chunked prefill is composed, as in JAX), and one
    training loss agrees to 1e-4."""
    cfg = tg.GPTConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=2,
                       seq_len=128, dtype=torch.float32, moe_experts=4,
                       moe_top_k=2, moe_every=2, fp8=True)
    params = tg.gpt_init(cfg, seed=2, device="cpu")
    for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
        params["blocks"][k] *= 4.0
    for k in ("router_w", "w_in", "w_out"):
        params["moe"][k] *= 4.0
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 77)]

    def run(paged, device):
        eng = InferenceEngine(cfg, params, n_slots=2, paged=paged,
                              device=device)
        try:
            return [eng.generate(p, max_new_tokens=12) for p in prompts]
        finally:
            eng.shutdown()

    g0, f0 = tmd.LAUNCHES, tfm.LAUNCHES
    assert run(False, cuda_device) == run(False, "cpu")
    assert tmd.LAUNCHES > g0 and tfm.LAUNCHES > f0
    assert run(True, cuda_device) == run(True, "cpu")

    batch = (torch.from_numpy(rng.integers(0, 512, (2, 64))),
             torch.from_numpy(rng.integers(0, 512, (2, 64))))
    losses = [float(tg.gpt_loss(cfg, {k: ({kk: vv.to(d) for kk, vv in
                                          v.items()} if isinstance(v, dict)
                                         else v.to(d))
                                      for k, v in params.items()},
                                tuple(t.to(d) for t in batch)))
              for d in (cuda_device, "cpu")]
    assert abs(losses[0] - losses[1]) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("R,H", [(100, 768), (37, 130), (64, 2048),
                                 (5, 8192), (1, 100)])
def test_addln_kernels_match_plain(cuda_device, dtype, tol, R, H):
    """The add-LN forward (out, mu, rstd) and backward (dx, ds, db)
    against their plain versions, vectorised and element-wise rows, one
    to eight warps a row; through the autograd entry each kernel
    launches once."""
    x, y, do = (_randn((R, H), dtype, cuda_device, i) for i in (1, 2, 3))
    s = 1.0 + 0.1 * _randn((H,), torch.float32, cuda_device, 4)
    b = 0.1 * _randn((H,), torch.float32, cuda_device, 5)
    got = tfk._addln_launch_fwd(x, y, s, b, 1e-5)
    want = tfk._addln_forward_reference(x, y, s, b, 1e-5)
    got_b = tfk._addln_launch_bwd(x, y, s, want[1], want[2], do)
    want_b = tfk._addln_backward_reference(x, y, s, want[1], want[2], do)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for g, w in zip(got + got_b, want + want_b):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol
    before = (tfk.ADDLN_FWD_LAUNCHES, tfk.ADDLN_BWD_LAUNCHES)
    xs, ys = (t.clone().requires_grad_(True) for t in (x, y))
    tfk.fused_add_layernorm(xs, ys, s, b).backward(do)
    torch.cuda.synchronize()
    assert (tfk.ADDLN_FWD_LAUNCHES, tfk.ADDLN_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert _rel(xs.grad, want_b[0]) <= tol
    assert torch.equal(xs.grad, ys.grad)


def test_addln_refuses_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(4, tfk.ADDLN_MAX_H + 8, device=cuda_device)
    ones = torch.ones(x.shape[1], device=cuda_device)
    with pytest.raises(ValueError):
        tfk.fused_add_layernorm(x, x, ones, ones)
    h = torch.zeros(4, 64, dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        tfk.fused_add_layernorm(h, h, ones[:64], ones[:64])


def test_paddle_bert_on_card_matches_cpu(cuda_device):
    """A small fused BERT-style encoder through the Paddle surface
    (FLAGS_fused_kernels=1: flash, fused LN-MLP and add-LN kernels): one
    step's loss and every parameter's gradient on the card against the
    CPU, f32, within 1e-4 of each gradient's largest value."""
    import chip_smoke
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice

    cfg = dict(vocab=512, hidden=128, layers=2, heads=4, ffn=512, seq=64)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg["vocab"], (2, cfg["seq"]))
    old = (tdevice._current[0], paddle.get_flags("FLAGS_fused_kernels"))
    paddle.set_flags({"FLAGS_fused_kernels": 1})
    try:
        paddle.set_device("cpu")
        paddle.seed(1)
        model = chip_smoke.bert_fused_model(
            paddle, chip_smoke.bert_model(paddle, **cfg))
        out = {}
        for where in ("cpu", "gpu"):
            paddle.set_device(where)
            model.to(device=where)
            before = tfk.ADDLN_FWD_LAUNCHES
            loss = paddle.nn.functional.cross_entropy(
                model(paddle.to_tensor(ids)), paddle.to_tensor(ids))
            loss.backward()
            out[where] = (float(loss), {n: p.grad._data.cpu() for n, p
                                        in model.named_parameters()})
            model.clear_gradients()
            assert tfk.ADDLN_FWD_LAUNCHES - before == (
                cfg["layers"] if where == "gpu" else 0)
    finally:
        tdevice._current[0] = old[0]
        paddle.set_flags(old[1])
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for name, g in out["cpu"][1].items():
        assert _rel(out["gpu"][1][name], g) <= 1e-4, name


@pytest.mark.parametrize("tf32_global", [True, False])
def test_conv_bn_pool_stack_f32_on_card_matches_cpu(cuda_device,
                                                    tf32_global):
    """Conv2D → BatchNorm2D → ReLU → MaxPool2D → Conv2D → AdaptiveAvgPool2D
    in f32 through the Paddle surface, one train-mode step on the card
    against the CPU with the same weights: the output, every gradient and
    the running statistics within 1e-4 of each one's largest value (the
    CPU's own f32 run sits within 2e-6 of its f64 run there). The
    convs reduce over 32·3·3 = 288 products, where TF32's 10-bit operands
    would be ~1e-3 apart; the port turns TF32 off for its f32 convs only
    for the call, so the global flag reads as it was set."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice

    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((4, 32, 20, 20)).astype(np.float32)
    old = (tdevice._current[0], torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32_global
    try:
        paddle.set_device("cpu")
        paddle.seed(3)
        nn = paddle.nn
        model = nn.Sequential(
            # no bias before the batch norm: its gradient is 0 in exact
            # arithmetic, so its f32 value is summation noise alone
            nn.Conv2D(32, 48, 3, padding=1, bias_attr=False),
            nn.BatchNorm2D(48), nn.ReLU(),
            nn.MaxPool2D(3, 2, 1, ceil_mode=True),
            nn.Conv2D(48, 16, 3, stride=2, padding="SAME", bias_attr=False),
            nn.AdaptiveAvgPool2D((2, 3)))
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        out = {}
        for where in ("cpu", "gpu"):
            paddle.set_device(where)
            model.set_state_dict(state)
            model.to(device=where)
            x = paddle.to_tensor(x_np)
            x.stop_gradient = False
            y = model(x)
            c = np.cos(np.arange(y.size, dtype=np.float32)).reshape(y.shape)
            (y * paddle.to_tensor(c)).sum().backward()
            assert torch.backends.cudnn.allow_tf32 == tf32_global
            # copies: on the CPU .cpu() is the buffer itself, which the
            # next set_state_dict overwrites
            out[where] = [t._data.detach().cpu().clone() for t in (
                [y, x.grad] + [p.grad for p in model.parameters()]
                + model.buffers())]
            model.clear_gradients()
    finally:
        tdevice._current[0], torch.backends.cudnn.allow_tf32 = old
    rel = [_rel(card, cpu) for card, cpu in zip(out["gpu"], out["cpu"])]
    assert max(rel) <= 1e-4, rel


def test_kv_block_through_codec_and_rpc_is_bit_identical(cuda_device):
    """A bf16 pool block exported on the card (the scheduler thread
    copies it to the host), sent through the RPC codec and a loopback
    ``RpcServer``, and imported into a second engine on the card, lands
    bit-identical: bf16 stays bf16 on the wire."""
    from paddle_tpu_torch.serving.rpc import RpcClient, RpcServer

    import dataclasses

    cfg, params = _small_engine_model()
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    kw = dict(n_slots=2, paged=True, block_size=16, prefill_chunk=32,
              prefix_cache=True, n_blocks=33, device=cuda_device)
    src, dst = InferenceEngine(cfg, params, **kw), \
        InferenceEngine(cfg, params, **kw)
    srv = None
    try:
        prompt = np.random.default_rng(5).integers(0, 512, 70)
        src.warm_prefix(prompt).result(timeout=120)

        def export(p, arrays):
            exp = src.export_kv_range(arrays["prompt"], int(p["start"]))
            meta = {k: exp[k] for k in ("start_block", "n_blocks",
                                        "covered_tokens")}
            return meta, {"kb": exp["kb"], "vb": exp["vb"]}

        srv = RpcServer({"export": export})
        cli = RpcClient(srv.addr, timeout=60.0)
        meta, arrs = cli.call("export", {"start": 0},
                              {"prompt": np.asarray(prompt, np.int32)},
                              crc=True)
        cli.close()
        assert arrs["kb"].dtype == torch.bfloat16
        assert arrs["kb"].device.type == "cpu"
        got = dst.import_kv_chunk(prompt, arrs["kb"], arrs["vb"],
                                  meta["start_block"],
                                  meta["covered_tokens"])
        assert got == meta["covered_tokens"] == 69

        def rows(eng):
            _, blocks = eng._prefix.match(np.asarray(prompt, np.int32))
            idx = torch.as_tensor(blocks, device=cuda_device)
            return (eng.cache.kb.index_select(0, idx).cpu(),
                    eng.cache.vb.index_select(0, idx).cpu())

        a = src.run_on_scheduler(rows)
        b = dst.run_on_scheduler(rows)
        for x, y in zip(a, b):
            assert x.dtype == torch.bfloat16
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    finally:
        if srv is not None:
            srv.close()
        src.shutdown(drain=False)
        dst.shutdown(drain=False)


def test_two_host_fleet_on_card_matches_monolithic(cuda_device, tmp_path):
    """A prefill-role and a decode-role host in one process on the card,
    over loopback RPC and a FileKVStore registry: greedy streams through
    the disaggregated path equal one monolithic card engine's (f32), and
    the decode host launched the paged decode kernel."""
    from paddle_tpu_torch.distributed import FileKVStore
    from paddle_tpu_torch.monitor import stat_get
    from paddle_tpu_torch.serving import HostAgent, connect_fleet

    cfg, params = _small_engine_model()

    def factory():
        return InferenceEngine(cfg, params, n_slots=2, paged=True,
                               block_size=16, prefill_chunk=32,
                               prefix_cache=True, n_blocks=65,
                               device=cuda_device)

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (70, 40, 9)]
    mono = factory()
    try:
        want = [mono.generate(p, max_new_tokens=12) for p in prompts]
    finally:
        mono.shutdown()
    store = FileKVStore(str(tmp_path / "kv"))
    agents = [HostAgent(store, "card", h, factory, role=r, heartbeat_s=0.1)
              for h, r in (("pf", "prefill"), ("dec", "decode"))]
    router = None
    routed0 = stat_get("fleet_prefill_routed")
    try:
        router = connect_fleet(store, "card", min_hosts=2)
        p0 = tpa.LAUNCHES
        got = [router.submit(p, max_new_tokens=12).result(timeout=300)
               for p in prompts]
        assert got == want
        assert stat_get("fleet_prefill_routed") - routed0 == 2
        assert tpa.LAUNCHES > p0
    finally:
        if router is not None:
            router.shutdown(drain=False)
        for a in agents:
            a.close()


def test_adamw_kernel_replayed_in_a_graph_matches_a_lone_launch(
        cuda_device):
    """Row 7 captured with a leaf table made before the capture and
    written after it (``SlotTables``), replayed 3 times with the rate
    written into a device scalar before each replay: bit-identical to 3
    uncaptured launches (tables made per call) on the same leaves and
    rates."""
    gen = torch.Generator().manual_seed(70)
    shapes = [(37,), (64, 33), (5, 7, 3)]

    def leaves():
        return [[torch.randn(s, generator=gen).to(cuda_device)
                 for s in shapes] for _ in range(4)]

    ps, gs, ms, vs = leaves()
    vs = [v.abs() for v in vs]
    ref = [[t.clone() for t in group] for group in (ps, gs, ms, vs)]
    rates = [1e-3, 5e-4, 2e-4]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, eager_form=True)
    lr = torch.zeros((), device=cuda_device)
    bc = torch.tensor([0.1, 0.001], device=cuda_device)
    tables = tfo.SlotTables()
    # the table is made outside the capture, for leaves of the same sizes
    tables.table("k", ps, [g.clone() for g in gs], ms, vs,
                 tfo._load().fused_opt_chunk())
    graph = torch.cuda.CUDAGraph()
    n0 = tfo.ADAMW_LAUNCHES
    with torch.cuda.graph(graph):
        g_static = [g.clone() for g in gs]
        sc = torch.cat([lr.reshape(1), bc])
        tfo._bucket_adamw(ps, g_static, ms, vs, sc, tables=tables,
                          key="k", **kw)
    tables.finalize()
    assert tfo.ADAMW_LAUNCHES == n0 + 1          # counted at capture
    for rate in rates:
        for dst, src in zip(g_static, gs):
            dst.copy_(src)
        lr.fill_(rate)
        graph.replay()
        rp, rg, rm, rv = ref
        tfo._bucket_adamw(rp, rg, rm, rv, torch.cat(
            [torch.full((1,), rate, device=cuda_device), bc]), **kw)
    torch.cuda.synchronize()
    for got, want in zip(ps + ms + vs, ref[0] + ref[2] + ref[3]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("opt_name,fused", [("adam", 1), ("adam", 0),
                                             ("momentum", 0)])
def test_captured_train_step_matches_uncaptured(cuda_device, opt_name,
                                                fused):
    """A small conv + batch-norm + linear net through ``TrainStep`` on the
    card: captured (one graph, replays) against ``capture=False`` from
    the same weights on the same batches, 4 steps, an LR schedule and a
    global-norm clip: losses, params and batch-norm buffers within 1e-6
    of the largest value; the fused Adam's launches come from the
    replays."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    paddle.seed(3)
    old = paddle.get_flags("FLAGS_fused_optimizer")["FLAGS_fused_optimizer"]
    paddle.set_flags({"FLAGS_fused_optimizer": fused})
    try:
        class Net(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.conv = paddle.nn.Conv2D(3, 8, 3, padding=1)
                self.bn = paddle.nn.BatchNorm2D(8)
                self.fc = paddle.nn.Linear(8 * 4 * 4, 5)

            def forward(self, x):
                y = paddle.nn.functional.relu(self.bn(self.conv(x)))
                return self.fc(paddle.flatten(
                    paddle.nn.functional.max_pool2d(y, 2), 1))

        a, b = Net(), Net()
        b.set_state_dict(a.state_dict())
        rng = np.random.default_rng(5)
        batches = [(rng.normal(size=(6, 3, 8, 8)).astype("float32"),
                    rng.integers(0, 5, (6,)).astype("int64"))
                   for _ in range(4)]

        def run(net, capture):
            sched = paddle.optimizer.lr.LinearWarmup(
                paddle.optimizer.lr.CosineAnnealingDecay(1e-2, T_max=4),
                warmup_steps=2, start_lr=0.0, end_lr=1e-2)
            clip = paddle.nn.ClipGradByGlobalNorm(1.0)
            opt = (paddle.optimizer.Adam(sched, parameters=net.parameters(),
                                         grad_clip=clip)
                   if opt_name == "adam" else
                   paddle.optimizer.Momentum(sched, 0.9,
                                             parameters=net.parameters(),
                                             grad_clip=clip))
            step = paddle.jit.TrainStep(
                net, lambda run_model, x, y: paddle.nn.functional
                .cross_entropy(run_model(x), y), opt, capture=capture)
            n0 = tfo.ADAMW_LAUNCHES
            losses = []
            for x, y in batches:
                losses.append(float(step(paddle.to_tensor(x),
                                         paddle.to_tensor(y))))
                sched.step()
            return losses, step, tfo.ADAMW_LAUNCHES - n0

        la, sa, na = run(a, True)
        lb, sb, nb = run(b, False)
        assert sa.captures == 1 and sb.captures == 0
        if fused:
            assert na == nb == 4
        np.testing.assert_allclose(la, lb, rtol=1e-6)
        for (k, va), (_, vb) in zip(a.state_dict().items(),
                                    b.state_dict().items()):
            va, vb = va.numpy(), vb.numpy()
            assert np.abs(va - vb).max() <= 1e-6 * max(np.abs(vb).max(),
                                                       1e-3), k
    finally:
        paddle.set_flags({"FLAGS_fused_optimizer": old})


def test_captured_step_refuses_a_host_read(cuda_device):
    """A loss that reads a value on the host cannot be captured: the
    step raises and says why (no fallback)."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    net = paddle.nn.Linear(4, 2)
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())

    def loss_fn(run_model, x):
        out = run_model(x).mean()
        if float(out) > 1e9:            # a host read
            out = out * 0
        return out

    step = paddle.jit.TrainStep(net, loss_fn, opt)
    x = paddle.to_tensor(np.ones((3, 4), "float32"))
    with pytest.raises(RuntimeError, match="cannot capture"):
        step(x)


def test_device_prefetcher_keeps_order_on_the_card(cuda_device):
    """DevicePrefetcher stages host batches on the card in their order,
    values unchanged, Tensors staying Tensors."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import DevicePrefetcher

    paddle.set_device("gpu")
    host = [(paddle.to_tensor(np.full((64, 3), i, "float32"), place="cpu"),
             np.full((64,), i, "int64")) for i in range(20)]
    got = list(DevicePrefetcher(host, size=2))
    assert len(got) == 20
    for i, (x, y) in enumerate(got):
        assert isinstance(x, paddle.Tensor) and x.place.type == "cuda"
        assert y.device.type == "cuda"
        assert float(x._data[0, 0]) == i and int(y[0]) == i


def _card_and_cpu(fn, *arrays):
    """``fn(paddle, *tensors)`` on the card and on the CPU port, from the
    same numpy inputs; the card's outputs must stay on the card."""
    import paddle_tpu_torch as paddle

    outs = []
    try:
        for where in ("gpu", "cpu"):
            paddle.set_device(where)
            out = fn(paddle, *[paddle.to_tensor(a) for a in arrays])
            out = list(out) if isinstance(out, (list, tuple)) else [out]
            outs.append(out)
    finally:
        paddle.set_device("gpu")
    for c, h in zip(*outs):
        assert c.place.type == "cuda" and c.dtype == h.dtype
    return [o.numpy() for o in outs[0]], [o.numpy() for o in outs[1]]


@pytest.mark.parametrize("mode,size,align", [
    ("nearest", (16, 14), False), ("nearest", (6, 4), True),
    ("bilinear", (16, 14), False), ("bilinear", (6, 4), False),
    ("bilinear", (8, 24), True), ("bicubic", (16, 14), False),
    ("bicubic", (6, 4), False)])
def test_interpolate_on_card_matches_cpu(cuda_device, mode, size, align):
    """The port's resize (jax.image.resize's weights, built per axis) on
    the card against the CPU port, 1e-5 of the largest value (f32 weight
    sums in another order)."""
    x = np.random.default_rng(44).normal(size=(2, 3, 8, 10)).astype(
        "float32")
    (card,), (cpu,) = _card_and_cpu(
        lambda p, t: p.nn.functional.interpolate(
            t, size=list(size), mode=mode, align_corners=align), x)
    np.testing.assert_allclose(card, cpu, rtol=1e-5,
                               atol=1e-5 * np.abs(cpu).max())


def test_median_on_card_matches_cpu(cuda_device):
    """jnp.median's even-count mean on the card: exact (a sort and one
    add)."""
    x = np.random.default_rng(45).normal(size=(6, 8, 10)).astype("float32")
    for kw in ({}, {"axis": 1}, {"axis": 2, "keepdim": True}):
        card, cpu = _card_and_cpu(lambda p, t: p.median(t, **kw), x)
        np.testing.assert_array_equal(card[0], cpu[0])


def test_unique_on_card_matches_cpu(cuda_device):
    """unique (first positions, inverse, counts) and unique_consecutive
    computed on the card, equal to the CPU port's."""
    x = np.random.default_rng(46).integers(0, 9, (40,)).astype("int64")
    card, cpu = _card_and_cpu(
        lambda p, t: p.unique(t, return_index=True, return_inverse=True,
                              return_counts=True), x)
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)
    np.testing.assert_array_equal(x[card[1]], card[0])
    card, cpu = _card_and_cpu(
        lambda p, t: p.unique_consecutive(t, return_inverse=True,
                                          return_counts=True), np.sort(x))
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)


def test_argsort_on_card_is_stable_and_matches_cpu(cuda_device):
    """argsort keeps the order of equal keys on the card, ascending and
    descending, as jnp.argsort does."""
    x = np.random.default_rng(47).integers(0, 4, (5, 300)).astype("float32")
    card, cpu = _card_and_cpu(
        lambda p, t: [p.argsort(t, axis=1), p.argsort(t, descending=True),
                      p.sort(t, axis=0)], x)
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)
    np.testing.assert_array_equal(card[0], np.argsort(x, axis=1,
                                                      kind="stable"))


def test_capture_survives_another_threads_copies(cuda_device):
    """A TrainStep captures while another thread pins host memory and
    copies it to the card on its own stream (what DevicePrefetcher does
    for the next batch during paddle.Model.fit): that work is not the
    capture's and must not invalidate it (the capture is thread-local),
    and the captured steps equal the uncaptured ones."""
    import threading

    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    stop = threading.Event()

    def copier():
        side = torch.cuda.Stream(cuda_device)
        while not stop.is_set():
            with torch.cuda.stream(side):
                host = torch.empty(1 << 18, pin_memory=True)
                host.to(cuda_device, non_blocking=True)
            side.synchronize()

    x = paddle.to_tensor(np.random.default_rng(48).normal(
        size=(32, 16)).astype("float32"))
    y = paddle.to_tensor(np.random.default_rng(49).integers(
        0, 4, (32,)).astype("int64"))
    losses = {}
    for capture in (True, False):
        paddle.seed(0)
        net = paddle.nn.Sequential(paddle.nn.Linear(16, 32),
                                   paddle.nn.ReLU(), paddle.nn.Linear(32, 4))
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        step = paddle.jit.TrainStep(
            net, lambda run, a, b: paddle.nn.functional.cross_entropy(
                run(a), b), opt, capture=capture)
        t = threading.Thread(target=copier, daemon=True)
        stop.clear()
        t.start()
        try:
            losses[capture] = [float(step(x, y)) for _ in range(4)]
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive()
        if capture:
            assert step.captures == 1
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)


def test_failed_capture_leaves_the_generator_usable(cuda_device):
    """A capture that raises (a host read in the loss) never closes the
    capture of the generator registered with it; the step renews the
    device's generator, so dropout and initializers draw on the card
    afterwards, and a model with dropout captures again."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    net = paddle.nn.Sequential(paddle.nn.Linear(4, 8), paddle.nn.Dropout(0.5),
                               paddle.nn.Linear(8, 2))
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())

    def reads_host(run, x):
        out = run(x).mean()
        if float(out) > 1e9:            # a host read
            out = out * 0
        return out

    x = paddle.to_tensor(np.ones((16, 4), "float32"))
    with pytest.raises(RuntimeError, match="cannot capture"):
        paddle.jit.TrainStep(net, reads_host, opt)(x)
    drawn = paddle.nn.functional.dropout(x, 0.5).numpy()
    assert set(np.unique(drawn)) <= {0.0, 2.0}
    paddle.nn.Linear(4, 4)
    step = paddle.jit.TrainStep(net, lambda run, a: run(a).mean(), opt)
    losses = [float(step(x)) for _ in range(4)]
    assert step.captures == 1 and all(map(math.isfinite, losses))


def _seeded(layer, seed):
    """numpy weights from ``seed`` under the layer's state names, so the
    card's and the CPU's layers hold the same numbers."""
    rng = np.random.default_rng(seed)
    layer.set_state_dict({k: (rng.normal(size=v.shape) * 0.3).astype(
        "float32") for k, v in layer.state_dict().items()})
    return layer


def test_lstm_with_sequence_length_on_card_matches_cpu(cuda_device):
    """A 2-layer bidirectional LSTM over padded rows with
    sequence_length on the card against the CPU port: outputs and final
    states 1e-5 of the largest (f32 sums in another order), the padded
    outputs 0 on both."""
    x = np.random.default_rng(50).normal(size=(4, 9, 8)).astype("float32")
    lens = np.array([9, 5, 1, 7], "int64")

    def run(p, t, n):
        out, (h, c) = _seeded(p.nn.LSTM(8, 16, 2, direction="bidirect"),
                              51)(t, sequence_length=n)
        return out, h, c

    card, cpu = _card_and_cpu(run, x, lens)
    for c, h in zip(card, cpu):
        np.testing.assert_allclose(c, h, rtol=1e-5,
                                   atol=1e-5 * np.abs(h).max())
    assert not card[0][1, 5:].any() and not card[0][2, 1:].any()


def test_beam_decode_on_card_matches_cpu(cuda_device):
    """BeamSearchDecoder over a GRU cell with peaked output weights (no
    near ties): the same tokens and lengths on the card as on the CPU,
    scores within 1e-5."""
    h0 = np.random.default_rng(52).normal(size=(3, 16)).astype("float32")

    def run(p, h):
        cell = _seeded(p.nn.GRUCell(16, 16), 53)
        emb = _seeded(p.nn.Embedding(30, 16), 54)
        proj = _seeded(p.nn.Linear(16, 30), 55)
        with p.no_grad():
            proj.weight.set_value(proj.weight * 10.0)
        dec = p.nn.BeamSearchDecoder(cell, 0, 1, 4, embedding_fn=emb,
                                     output_fn=proj)
        return p.nn.dynamic_decode(dec, inits=h, max_step_num=10)

    (cs, csc, cl), (hs, hsc, hl) = _card_and_cpu(run, h0)
    np.testing.assert_array_equal(cs, hs)
    np.testing.assert_array_equal(cl, hl)
    np.testing.assert_allclose(csc, hsc, rtol=1e-5, atol=1e-5)


def test_conv_transpose_on_card_matches_cpu(cuda_device):
    """conv2d_transpose (stride 2, unequal pads, output_padding, groups)
    in f32 on the card, TF32 off, against the CPU: output and both
    gradients 1e-4 of the largest."""
    import paddle_tpu_torch as paddle

    rng = np.random.default_rng(56)
    x = rng.normal(size=(2, 8, 9, 7)).astype("float32")
    w = rng.normal(size=(8, 3, 3, 3)).astype("float32")
    g = rng.normal(size=(2, 6, 19, 13)).astype("float32")
    outs = []
    try:
        for where in ("gpu", "cpu"):
            paddle.set_device(where)
            xt = paddle.to_tensor(x, stop_gradient=False)
            wt = paddle.to_tensor(w, stop_gradient=False)
            y = paddle.nn.functional.conv2d_transpose(
                xt, wt, stride=2, padding=[1, 0, 1, 2], output_padding=1,
                groups=2)
            (y * paddle.to_tensor(g)).sum().backward()
            outs.append([y.numpy(), xt.grad.numpy(), wt.grad.numpy()])
    finally:
        paddle.set_device("gpu")
    for c, h in zip(*outs):
        assert c.shape == h.shape
        np.testing.assert_allclose(c, h, rtol=1e-4,
                                   atol=1e-4 * np.abs(h).max())


def test_pool_masks_on_card_match_cpu(cuda_device):
    """Pool masks (ceil mode, 3-d, adaptive) and max_unpool2d on the card
    equal the CPU's exactly."""
    rng = np.random.default_rng(57)
    x4 = rng.normal(size=(2, 3, 13, 11)).astype("float32")
    x5 = rng.normal(size=(1, 2, 7, 6, 5)).astype("float32")

    def run(p, a, b):
        F = p.nn.functional
        v, m = F.max_pool2d(a, 3, 2, 1, ceil_mode=True, return_mask=True)
        v2, m2 = F.max_pool2d(a, 2, 2, return_mask=True)
        return [v, m, F.max_pool3d(b, 2, 2, return_mask=True)[1],
                F.adaptive_max_pool2d(a, [4, 3], return_mask=True)[1],
                F.max_unpool2d(v2, m2, 2, 2, output_size=[13, 11])]

    card, cpu = _card_and_cpu(run, x4, x5)
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)


def test_captured_step_draws_from_tensor_random(cuda_device):
    """A TrainStep whose loss adds noise from paddle.randn and
    paddle.rand: the captured step registers the device's generator, so
    its first 3 losses equal the uncaptured step's from the same
    generator state (1e-6), and replays at learning rate 0 on one batch
    draw fresh noise (distinct losses)."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    x = paddle.to_tensor(np.random.default_rng(58).normal(
        size=(64, 16)).astype("float32"))

    def loss_fn(run, a):
        noisy = a + 0.1 * paddle.randn(a.shape) * paddle.rand([1])
        return (run(noisy) ** 2).mean()

    losses = {}
    for capture in (True, False):
        paddle.seed(5)
        net = _seeded(paddle.nn.Linear(16, 4), 59)
        opt = paddle.optimizer.SGD(0.05, parameters=net.parameters())
        step = paddle.jit.TrainStep(net, loss_fn, opt, capture=capture)
        losses[capture] = [float(step(x)) for _ in range(3)]
        if capture:
            assert step.captures == 1
            step.scale_lr(0.0)
            fresh = [float(step(x)) for _ in range(4)]
            assert len(set(fresh)) == 4
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)


def test_yolo_loss_inside_a_captured_step(cuda_device):
    """A 1x1 conv head under ``yolo_loss`` through ``TrainStep``: the
    captured step (one graph; the loss reads nothing on the host) against
    ``capture=False`` from the same weights, 3 steps of Momentum: losses
    and weights within 1e-6 of the largest value."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    rng = np.random.default_rng(60)
    x = rng.normal(size=(2, 8, 8, 8)).astype("float32")
    box = np.concatenate([rng.uniform(0.2, 0.8, (2, 5, 2)),
                          rng.uniform(0.05, 0.4, (2, 5, 2))], -1)
    box[:, 3:] = 0.0
    label = rng.integers(0, 4, (2, 5)).astype("int32")

    def run(capture):
        net = _seeded(paddle.nn.Conv2D(8, 3 * 9, 1), 61)
        opt = paddle.optimizer.Momentum(0.01, 0.9,
                                        parameters=net.parameters())
        step = paddle.jit.TrainStep(
            net, lambda run_model, x_, b_, l_: paddle.mean(
                paddle.vision.ops.yolo_loss(run_model(x_), b_, l_, anchors,
                                            [0, 1, 2], 4, 0.5, 16)),
            opt, capture=capture)
        ts = [paddle.to_tensor(a) for a in (x, box.astype("float32"),
                                            label)]
        losses = [float(step(*ts)) for _ in range(3)]
        return losses, step.captures, net.weight.numpy()

    la, ca, wa = run(True)
    lb, cb, wb = run(False)
    assert (ca, cb) == (1, 0)
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    assert np.abs(wa - wb).max() <= 1e-6 * np.abs(wb).max()


@pytest.mark.parametrize("masked,dg", [(False, 1), (True, 2)])
def test_deform_conv2d_on_card_matches_cpu(cuda_device, masked, dg):
    """deform_conv2d (v1, and v2 with a mask and 2 deformable groups)
    in f32 on the card against the CPU port: output and the gradients of
    x, offset, mask and weight within 1e-5 of the largest (f32 sums in
    another order; the gathers' backward accumulates with atomics)."""
    rng = np.random.default_rng(62)
    N, C, H, W, k = 2, 8, 12, 10, 3
    x = rng.normal(size=(N, C, H, W)).astype("float32")
    off = (rng.normal(size=(N, 2 * dg * k * k, H, W)) * 2).astype("float32")
    w = rng.normal(size=(6, C, k, k)).astype("float32")
    m = rng.uniform(size=(N, dg * k * k, H, W)).astype("float32")

    def run(p, x_, off_, w_, m_):
        for t in (x_, off_, w_, m_):
            t.stop_gradient = False
        out = p.vision.ops.deform_conv2d(x_, off_, w_, padding=1,
                                         deformable_groups=dg,
                                         mask=m_ if masked else None)
        (out * out).sum().backward()
        grads = [x_.grad, off_.grad, w_.grad] + ([m_.grad] if masked
                                                 else [])
        return [out] + grads

    card, cpu = _card_and_cpu(run, x, off, w, m)
    for c, h in zip(card, cpu):
        assert np.abs(c - h).max() <= 1e-5 * np.abs(h).max()


def test_multiclass_nms_on_card_matches_cpu(cuda_device):
    """multiclass_nms on the card (the candidates' IoU and the greedy
    sweep on the device) against the CPU port: equal rows, counts and
    indices, with nms_eta < 1 and keep_top_k; scores a permutation of
    distinct values (no ties)."""
    rng = np.random.default_rng(63)
    N, C, M = 3, 6, 300
    xy = rng.uniform(0, 200, (N, M, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (N, M, 2))],
                           -1).astype("float32")
    scores = (rng.permutation(N * C * M).reshape(N, C, M)
              / (N * C * M)).astype("float32")

    def run(p, b, s):
        return p.vision.ops.multiclass_nms(
            b, s, score_threshold=0.05, nms_top_k=100, keep_top_k=50,
            nms_threshold=0.5, nms_eta=0.95, normalized=False,
            background_label=-1, return_index=True)

    card, cpu = _card_and_cpu(run, boxes, scores)
    for c, h in zip(card, cpu):
        np.testing.assert_array_equal(c, h)
    assert card[1].sum() == len(card[0]) > 0


def test_o2_fused_feedforward_on_card(cuda_device):
    """``fused_feedforward`` under amp O2 on the card: bf16 x and
    weights beside f32 LayerNorm scales (the kernels take the scale in
    f32), post-LN and pre-LN, FLAGS_fused_kernels=1 (rows 4-6: the
    launch counts rise) against the same op with the flag 0 (the
    composed math): bf16 outputs within 2e-2 of the largest (the kernels
    round where the composed path rounds after every op)."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    rng = np.random.default_rng(64)
    B, S, H, M = 2, 64, 256, 1024
    arrays = [rng.normal(size=(B, S, H)) * 0.5,
              rng.normal(size=(H, M)) * 0.05, rng.normal(size=(M,)) * 0.1,
              rng.normal(size=(M, H)) * 0.05, rng.normal(size=(H,)) * 0.1]
    x, w1, b1, w2, b2 = (paddle.to_tensor(a.astype("float32")).astype(
        "bfloat16") for a in arrays)
    ln_w = paddle.to_tensor((1 + rng.normal(size=(H,)) * 0.1).astype(
        "float32"))
    ln_b = paddle.to_tensor((rng.normal(size=(H,)) * 0.1).astype("float32"))
    old = paddle.get_flags("FLAGS_fused_kernels")["FLAGS_fused_kernels"]
    try:
        for pre in (False, True):
            outs = []
            for flag in (1, 0):
                paddle.set_flags({"FLAGS_fused_kernels": flag})
                n0 = (tfk.FWD_LAUNCHES, tfk.ADDLN_FWD_LAUNCHES)
                y = paddle.ops.fused_feedforward(
                    x, w1, b1, w2, b2, ln_w, ln_b, pre_layer_norm=pre,
                    activation="gelu")
                assert str(y.dtype) == "torch.bfloat16"
                if flag:
                    assert tfk.FWD_LAUNCHES > n0[0]
                    assert (tfk.ADDLN_FWD_LAUNCHES > n0[1]) == (not pre)
                outs.append(y.astype("float32").numpy())
            assert np.abs(outs[0] - outs[1]).max() <= 2e-2 * np.abs(
                outs[1]).max()
    finally:
        paddle.set_flags({"FLAGS_fused_kernels": old})


@pytest.mark.parametrize("pdt,mdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_fused_optimizer_skip_flag(cuda_device, pdt, mdt):
    """Rows 7 and 8 with the skip flag: False (and null) bit-identical to
    the plain version; True leaves params, moments (and LAMB's params
    through the trust step) bit-identical to the inputs."""
    sc = torch.tensor([3e-3, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                      device=cuda_device)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.05, l2=0.0, eager_form=True)
    for flag in (None, False, True):
        ps, gs, ms, vs = _opt_leaves(pdt, mdt, cuda_device, 31)
        before = [t.clone() for t in ps + ms + vs]
        skip = None if flag is None else torch.tensor(flag,
                                                      device=cuda_device)
        want = [tfo._adamw_flat_reference(p, g, m, v, sc[0], sc[1], sc[2],
                                          skip=skip, **kw)
                for p, g, m, v in zip(ps, gs, ms, vs)]
        tfo._bucket_adamw(ps, gs, ms, vs, sc, skip=skip, **kw)
        torch.cuda.synchronize()
        for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
            assert torch.equal(p, wp) and torch.equal(m, wm) \
                and torch.equal(v, wv)
        if flag:
            assert all(torch.equal(a, b)
                       for a, b in zip(ps + ms + vs, before))
    lkw = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    for flag in (False, True):
        ps, gs, ms, vs = _opt_leaves(pdt, mdt, cuda_device, 32)
        before = [t.clone() for t in ps + ms + vs]
        skip = torch.tensor(flag, device=cuda_device)
        want = [tfo._lamb_flat_reference(p, g, m, v, sc[1], sc[2], **lkw)
                for p, g, m, v in zip(ps, gs, ms, vs)]
        got = {}
        for idx, rs in tfo._bucket_lamb(ps, gs, ms, vs, sc, skip=skip,
                                        **lkw):
            got.update({i: r.clone() for i, r in zip(idx, rs)})
            for i, r in zip(idx, rs):
                tfo._apply_trust(ps[i], r, 1e-2, skip)
        torch.cuda.synchronize()
        if flag:
            assert all(torch.equal(a, b)
                       for a, b in zip(ps + ms + vs, before))
        else:
            for i, (wm, wv, wr) in enumerate(want):
                assert torch.equal(ms[i], wm) and torch.equal(vs[i], wv)
                assert torch.equal(got[i], wr)


def test_captured_step_trips_without_recapture(cuda_device):
    """A captured ``TrainStep(sentinel=True)`` (fused Adam: row 7 in the
    graph; batch norm's buffers) fed a NaN batch through
    ``FLAGS_fault_inject``: the replay trips, params, slots (beta pows
    included) and the running statistics stay bit-identical, no graph is
    captured again, and the next batch trains."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.resilience import configure_faults

    paddle.set_device("gpu")
    paddle.seed(4)
    old = paddle.get_flags("FLAGS_fused_optimizer")["FLAGS_fused_optimizer"]
    paddle.set_flags({"FLAGS_fused_optimizer": 1})
    try:
        net = paddle.nn.Sequential(
            paddle.nn.Conv2D(3, 8, 3, padding=1), paddle.nn.BatchNorm2D(8),
            paddle.nn.ReLU(), paddle.nn.Flatten(),
            paddle.nn.Linear(8 * 8 * 8, 5))
        opt = paddle.optimizer.Adam(1e-2, parameters=net.parameters())
        step = paddle.jit.TrainStep(
            net, lambda run, x, y: paddle.nn.functional.cross_entropy(
                run(x), y), opt, sentinel=True)
        rng = np.random.default_rng(6)
        batch = lambda: (paddle.to_tensor(rng.normal(size=(4, 3, 8, 8))
                                          .astype("float32")),
                         paddle.to_tensor(rng.integers(0, 5, (4,))))
        for _ in range(3):
            step(*batch())
        state = lambda: [t.clone() for t in (
            [p._data for p in net.parameters()]
            + [t for v in step._slot_values.values() for t in v]
            + [b._data for _, b in net.named_buffers()])]
        before, n0 = state(), tfo.ADAMW_LAUNCHES
        configure_faults("nan_grad@step=3")
        try:
            loss = step(*batch())
        finally:
            configure_faults("")
        assert bool(loss.health["trip"]) and int(loss.health["trips"]) == 1
        assert step.captures == 1 and tfo.ADAMW_LAUNCHES == n0 + 1
        assert all(torch.equal(a, b) for a, b in zip(state(), before))
        loss = step(*batch())
        assert math.isfinite(float(loss)) and not bool(loss.health["trip"])
        assert not all(torch.equal(a, b) for a, b in zip(state(), before))
    finally:
        paddle.set_flags({"FLAGS_fused_optimizer": old})


def test_snapshot_copy_precedes_the_next_in_place_update(cuda_device):
    """The guardian's host copy runs on a side stream; the step's stream
    waits for it, so an in-place update queued right after the fill
    cannot reach the copy."""
    from paddle_tpu_torch.resilience.guardian import _HostCopy

    src = {"a": torch.randn(64 << 20, device=cuda_device),
           "n": torch.tensor(3, dtype=torch.int64)}
    want = src["a"].cpu()
    buf = _HostCopy(src)
    try:
        buf.fill(src)
        src["a"].mul_(2.0)
        got = buf.tree()
        assert torch.equal(got["a"], want) and int(got["n"]) == 3
    finally:
        buf.release()


def test_a_refused_pinning_is_counted_and_leaves_no_error(cuda_device):
    """Page-locking a range that is already registered is refused: the
    guardian warns and counts it (``host_pin_failures()``), and the CUDA
    runtime has no error left over for the next, unrelated launch."""
    from paddle_tpu_torch.resilience import guardian

    buf = guardian._HostCopy({"a": torch.zeros(1 << 20, device=cuda_device)})
    try:
        assert buf.pinned
        n0 = guardian.host_pin_failures()
        with pytest.warns(UserWarning, match="page-locking"):
            assert not guardian._pin(buf.host[0].data_ptr(), 4096,
                                     cuda_device)
        assert guardian.host_pin_failures() - n0 == 1
        x = torch.full((8,), 2.0, device=cuda_device)
        assert float(x.sum()) == 16.0
    finally:
        buf.release()


# -- the static-graph world: Executor.run as a captured CUDA graph ------------

def _static_net_program(paddle, batch, opt_name, fused):
    """A small conv + batch-norm + linear net as a static program with a
    ``minimize`` spec, its parameters made on the current device."""
    from paddle_tpu_torch import static

    paddle.enable_static()
    main = static.Program()
    try:
        with static.program_guard(main, static.Program()):
            paddle.seed(3)
            conv = paddle.nn.Conv2D(3, 8, 3, padding=1)
            bn = paddle.nn.BatchNorm2D(8)
            fc = paddle.nn.Linear(8 * 4 * 4, 5)
            x = static.data("x", [batch, 3, 8, 8])
            y = static.data("y", [batch], "int64")
            h = paddle.nn.functional.relu(bn(conv(x)))
            logits = fc(paddle.flatten(
                paddle.nn.functional.max_pool2d(h, 2), 1))
            loss = paddle.nn.functional.cross_entropy(logits, y)
            opt = (paddle.optimizer.Adam(1e-2) if opt_name == "adam"
                   else paddle.optimizer.Momentum(1e-2, 0.9))
            opt.minimize(loss)
    finally:
        paddle.disable_static()
    return main, loss, [conv, bn, fc]


@pytest.mark.parametrize("opt_name,fused", [("adam", 1), ("adam", 0),
                                             ("momentum", 0)])
def test_static_captured_run_matches_uncaptured(cuda_device, opt_name,
                                                fused):
    """The same static training program on the card: ``Executor.run`` as
    a captured CUDA graph (one capture, then replays) against the same
    runs with the capture turned off (the plan's step called eagerly),
    4 runs from the same weights: losses, parameters and batch-norm
    buffers within 1e-6 of the largest value; the fused Adam's launches
    come from the replays."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static

    paddle.set_device("gpu")
    old = paddle.get_flags("FLAGS_fused_optimizer")["FLAGS_fused_optimizer"]
    paddle.set_flags({"FLAGS_fused_optimizer": fused})
    try:
        rng = np.random.default_rng(5)
        feeds = [{"x": rng.normal(size=(6, 3, 8, 8)).astype("float32"),
                  "y": rng.integers(0, 5, (6,)).astype("int64")}
                 for _ in range(4)]
        runs = {}
        for captured in (True, False):
            main, loss, layers = _static_net_program(paddle, 6, opt_name,
                                                     fused)
            exe = static.Executor(paddle.CUDAPlace(0))
            n0 = tfo.ADAMW_LAUNCHES
            losses = []
            for feed in feeds:
                if captured:
                    out = exe.run(main, feed=feed, fetch_list=[loss])[0]
                else:
                    plan = static._Plan(main, [loss._expr], cuda_device)
                    for spec in plan.specs:
                        spec.write_lr()
                    out = plan.step({k: torch.as_tensor(v).to(cuda_device)
                                     for k, v in feed.items()})[0]
                losses.append(float(out))
            state = [v.numpy() for m in layers
                     for v in m.state_dict().values()]
            runs[captured] = (losses, state, exe.captures, exe.replays,
                              tfo.ADAMW_LAUNCHES - n0)
        (la, sa, ca, ra, na), (lb, sb, _, _, nb) = runs[True], runs[False]
        assert ca == 1 and ra == 3
        if fused:
            assert na == 4 and nb == 4
        np.testing.assert_allclose(la, lb, rtol=1e-6)
        for va, vb in zip(sa, sb):
            assert np.abs(va - vb).max() <= 1e-6 * max(np.abs(vb).max(),
                                                       1e-3)
    finally:
        paddle.set_flags({"FLAGS_fused_optimizer": old})


def test_static_new_feed_shape_captures_anew(cuda_device):
    """A feed of another shape or dtype is another signature: a new
    graph, never a stale replay; the old signature replays again."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static

    paddle.set_device("gpu")
    paddle.enable_static()
    main = static.Program()
    try:
        with static.program_guard(main, static.Program()):
            lin = paddle.nn.Linear(16, 4)
            x = static.data("x", [-1, 16])
            y = paddle.tanh(lin(x))
    finally:
        paddle.disable_static()
    exe = static.Executor(paddle.CUDAPlace(0))
    rng = np.random.default_rng(1)
    w = lin.weight.numpy()
    b = lin.bias.numpy()
    for n, captures in ((3, 1), (3, 1), (5, 2), (3, 2), (5, 2)):
        xs = rng.normal(size=(n, 16)).astype("float32")
        (got,) = exe.run(main, feed={"x": xs}, fetch_list=[y])
        np.testing.assert_allclose(got, np.tanh(xs @ w + b), rtol=1e-5,
                                   atol=1e-6)
        assert exe.captures == captures and exe.last_run["captured"]
    # f64 numpy is fed as the placeholder's f32: the same signature
    exe.run(main, feed={"x": rng.normal(size=(5, 16))}, fetch_list=[y])
    assert exe.captures == 2


def test_static_while_loop_runs_uncaptured(cuda_device):
    """A program holding a while_loop (a host loop) runs uncaptured on the
    card, says so, and computes what the loop computes."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static

    paddle.set_device("gpu")
    paddle.enable_static()
    main = static.Program()
    try:
        with static.program_guard(main, static.Program()):
            x = static.data("x", [4])
            n = paddle.zeros([1], "float32")
            i, v = static.nn.while_loop(lambda i, v: paddle.sum(i) < 5.0,
                                        lambda i, v: [i + 1.0, v * 2.0],
                                        [n, x])
    finally:
        paddle.disable_static()
    exe = static.Executor(paddle.CUDAPlace(0))
    xs = np.arange(4, dtype="float32")
    for _ in range(2):
        got = exe.run(main, feed={"x": xs}, fetch_list=[i, v])
        np.testing.assert_array_equal(got[1], xs * 32.0)
        assert not exe.last_run["captured"]
        assert "host" in exe.last_run["reason"]
    assert exe.captures == 0 and exe.uncaptured_runs == 2


def test_kernel_wrappers_on_meta_launch_nothing(cuda_device):
    """Shape inference runs an op on meta tensors: the kernel wrappers
    take their plain path there (shapes only) and launch nothing."""
    q = torch.empty(2, 4, 128, 64, device="meta")
    counts = (tfa.LAUNCHES, tfa.BWD_LAUNCHES, tfk.FWD_LAUNCHES,
              tfk.ADDLN_FWD_LAUNCHES)
    o = tfa.flash_attention_arrays(q, q, q)
    x = torch.empty(256, 64, device="meta")
    w1 = torch.empty(64, 128, device="meta")
    b1 = torch.empty(128, device="meta")
    w2 = torch.empty(128, 64, device="meta")
    b2 = torch.empty(64, device="meta")
    s = torch.empty(64, device="meta")
    y = tfk.fused_ln_mlp(x, w1, b1, w2, b2, ln_scale=s, ln_bias=s)
    z = tfk.fused_add_layernorm(x, x, s, s)
    assert o.shape == q.shape and o.is_meta
    assert y.shape == x.shape and y.is_meta and z.is_meta
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES, tfk.FWD_LAUNCHES,
            tfk.ADDLN_FWD_LAUNCHES) == counts


def test_static_captured_dropout_draws_every_replay(cuda_device):
    """Dropout recorded into a program draws from the device's generator,
    registered with the captured graph: each replay a fresh mask at the
    keep rate."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static

    paddle.set_device("gpu")
    paddle.enable_static()
    main = static.Program()
    try:
        with static.program_guard(main, static.Program()):
            x = static.data("x", [100000])
            y = paddle.nn.functional.dropout(x, p=0.3)
    finally:
        paddle.disable_static()
    exe = static.Executor(paddle.CUDAPlace(0))
    ones = np.ones(100000, "float32")
    masks = [exe.run(main, feed={"x": ones}, fetch_list=[y])[0] != 0
             for _ in range(3)]
    assert exe.captures == 1 and exe.replays == 2
    assert not np.array_equal(masks[1], masks[2])
    for m in masks:
        assert abs(m.mean() - 0.7) <= 5 * np.sqrt(0.21 / 100000)
