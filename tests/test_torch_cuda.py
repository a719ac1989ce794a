"""paddle_tpu_torch on the card: each CUDA kernel against its plain
PyTorch version, the engine's token streams on the card against the
same engine on the CPU, and a training step's loss and grads on the card
against the CPU. Every test is marked ``cuda`` and skips without a GPU.
This file imports neither JAX nor paddle_tpu, so it runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

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
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.parallel import DistributedTrainStep
from paddle_tpu_torch.serving import InferenceEngine
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
                                            (70, 70, 128, False)])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, sq, sk, d,
                                    causal):
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


def test_engine_on_card_matches_cpu(cuda_device):
    """Both cache modes on the card (flash prefill in fixed mode, paged
    decode in paged mode) give the CPU engine's greedy tokens (f32,
    head_dim 64, block matrices scaled so tokens vary)."""
    cfg = tg.GPTConfig(vocab_size=512, hidden=128, n_layers=2, n_heads=2,
                       seq_len=128, dtype=torch.float32)
    params = tg.gpt_init(cfg, seed=0, device="cpu")
    for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
        params["blocks"][k] *= 4.0
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
