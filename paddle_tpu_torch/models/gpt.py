"""GPT-family decoder LM on PyTorch: the serving and training subsets
of ``paddle_tpu/models/gpt.py``, dense and mixture-of-experts.

Same parameter tree (a dict of tensors with the same keys and shapes,
block leaves stacked on a leading layer dim), same numerics (compute
dtype for the block matmuls, LayerNorm and softmax in f32, bf16 operands
with f32 accumulation for the tied logits head), same cache layouts:

- fixed slots ``(n_slots, layers, heads, max_len, head_dim)``;
- the paged block pool ``(n_blocks, layers, heads, block_size,
  head_dim)`` with per-slot block tables, pool block 0 the garbage sink.

Where the JAX package returns updated cache buffers from a pure
function (and the engine donates them), the port writes the same rows
in place and returns the same tensors.

Training: :func:`gpt_loss` (causal-LM cross entropy, optionally
sequence-chunked by :func:`_chunked_ce`) is differentiated by autograd.
``remat`` wraps each block in ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint``; its save policy is a memory/speed choice
that does not change the numbers and is not copied).

The ``lax.scan`` over layers is a Python loop over the leading layer
dim. Attention is the flash-attention kernels on a CUDA tensor
(``ops/flash_attention.py``, forward and backward), the paged decode's
attention the paged-attention kernel (``ops/paged_attention.py``), and
with ``fused_mlp`` the MLP half of the prefill and training blocks is the
fused LN-MLP kernels (``ops/fused_kernels.py``); on a CPU tensor each
runs its plain PyTorch version. The one-token decode and the chunked
prefill always run the composed MLP, whatever ``fused_mlp`` says, as in
JAX.

int8 weights (:func:`quantize_gpt_weights`) feed the decode steps only:
each block matmul with a ``{"q", "s"}`` weight goes through
``ops/int8_matmul.py`` (the int8 kernel on the card) with dynamic
per-tensor activation quantization. Prefill, chunked prefill and
training raise on them, as JAX never feeds them there.

fp8 (``GPTConfig.fp8``, None following ``FLAGS_fp8_matmul``): the MLP
half of the training and fixed-slot prefill blocks runs both matmuls
through ``amp/fp8.py``'s ``fp8_linear`` (the e4m3 kernel on the card),
taking precedence over ``fused_mlp``, as in JAX; the decode steps and
the chunked prefill stay composed.

Mixture of experts (``GPTConfig.moe_experts > 0``): every
``moe_every``-th block's MLP is the routed expert FFN of ``nn/moe.py``
(the dispatch-gather kernel on the card), with its own ``params["moe"]``
subtree (leading dim: the MoE layers) while the dense MLP leaves stack
only the other layers. Training routes with the capacity factor (drops
pass the residual through) and adds the router's aux and z losses;
every inference path routes droplessly, and the decode steps return the
router's ``(counts, dropped)`` as a third element.

Speculative decoding and the prefix cache: :func:`gpt_truncate` builds
a layer-truncated draft that shares the target's embeddings and final
LN; :func:`gpt_verify_step` / :func:`gpt_verify_step_paged` score C
tokens per row in one pass over either cache (the draft's proposals
plus the bonus position); the paged verify shares its attention body
with :func:`gpt_prefill_chunk`, which therefore continues from any
cached length — :func:`gpt_prefill_prefix`, the JAX name of the prefix
cache's tail, is that chunk at an unaligned start. Their attention is
composed PyTorch, as in JAX (a multi-query shape the decode kernel does
not cover), and their MLP the composed one (int8 weights allowed in the
verify); the verify steps raise on MoE configs, as in JAX.

The expert-parallel, ring-attention and pipeline branches are not ported
yet and raise ``NotImplementedError`` where a config asks for one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..amp.fp8 import fp8_linear
from ..core import flags
from ..nn.moe import moe_ffn
from ..ops.flash_attention import NEG_INF, flash_attention_arrays
from ..ops.fused_kernels import fused_ln_mlp
from ..ops.int8_matmul import _quant_scale, _quantize, dynamic_int8_matmul
from ..ops.paged_attention import paged_attention_arrays

__all__ = ["GPTConfig", "gpt_init", "gpt_forward", "gpt_loss", "gpt_tiny",
           "gpt_small", "gpt_1p3b", "gpt_nano", "gpt_prefill",
           "gpt_decode_step", "gpt_decode_step_paged", "gpt_prefill_chunk",
           "gpt_truncate", "gpt_verify_step", "gpt_verify_step_paged",
           "gpt_prefill_prefix", "params_from_jax", "quantize_gpt_weights",
           "bert_base_config"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    seq_len: int = 1024
    mlp_ratio: int = 4
    dtype: Any = torch.bfloat16        # compute dtype
    param_dtype: Any = torch.float32   # master weights
    n_stages: int = 1
    remat: bool = False
    # kept for parity with the JAX config: on a CUDA tensor the port's
    # attention always runs the flash kernel (the TPU's auto thresholds
    # were measured on a v5e and do not carry over)
    use_flash: Optional[bool] = None
    scan_unroll: Optional[int] = None
    ring_attention: bool = False
    seq_axis: str = "sharding"
    # fused LN-MLP kernels in the MLP half (None follows
    # FLAGS_fused_kernels)
    fused_mlp: Optional[bool] = None
    # fp8 (e4m3) MLP matmuls (None follows FLAGS_fp8_matmul); takes the
    # unfused MLP when both fp8 and fused_mlp are on, as in JAX
    fp8: Optional[bool] = None
    # mixture of experts: moe_experts=E routes every moe_every-th block's
    # MLP through an E-expert top-k MoE; 0 keeps the dense model
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    # training dispatch capacity (C = ceil(cf·k·T/E), overflow dropped
    # with residual passthrough); inference paths are always dropless
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2     # load-balance loss weight in gpt_loss
    moe_z_weight: float = 1e-3       # router z-loss weight in gpt_loss
    # expert-parallel mesh axis: not ported (raises when set)
    moe_axis: Optional[str] = None

    @property
    def head_dim(self):
        return self.hidden // self.n_heads

    @property
    def mlp_hidden(self):
        return self.hidden * self.mlp_ratio

    @property
    def moe_layer_ids(self):
        """Indices of MoE blocks: every moe_every-th layer (1-based), so
        moe_every=2 → layers 1, 3, 5, ...; moe_every=1 → all layers."""
        if self.moe_experts <= 0:
            return ()
        n = max(1, int(self.moe_every))
        return tuple(i for i in range(self.n_layers) if i % n == n - 1)


def gpt_tiny(**kw):
    d = dict(vocab_size=512, hidden=64, n_layers=4, n_heads=4, seq_len=64)
    d.update(kw)
    return GPTConfig(**d)


def gpt_small(**kw):
    d = dict(hidden=768, n_layers=12, n_heads=12, seq_len=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt_1p3b(**kw):
    # GPT-3 1.3B: the reference Fleet hybrid benchmark config
    d = dict(hidden=2048, n_layers=24, n_heads=16, seq_len=2048)
    d.update(kw)
    return GPTConfig(**d)


def bert_base_config(**kw):
    # BERT-base shapes as an encoder-sized LM config of the GPT model
    d = dict(vocab_size=30592, hidden=768, n_layers=12, n_heads=12,
             seq_len=512)
    d.update(kw)
    return GPTConfig(**d)


def gpt_nano(**kw):
    d = dict(vocab_size=512, hidden=64, n_layers=2, n_heads=4, seq_len=64)
    d.update(kw)
    return GPTConfig(**d)


def gpt_truncate(cfg: GPTConfig, params, n_layers: int):
    """Layer-truncated draft model: the first ``n_layers`` blocks of
    ``params`` (views of the target's leaves) with wte, wpe and the final
    LN SHARED with the target (the same tensors). Returns ``(draft_cfg,
    draft_params)`` for ``serving.InferenceEngine(draft=...)``.
    ``params`` must be the plain gpt_init layout (quantize after
    truncation, not before); MoE configs raise, as in JAX."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(
            f"n_layers={n_layers} outside [1, {cfg.n_layers}]")
    if cfg.moe_layer_ids:
        raise ValueError(
            "gpt_truncate does not support MoE configs: the dense-MLP "
            "and expert subtrees stack over different layer subsets, so "
            "a [:n_layers] slice has no single meaning")
    draft = dict(params)
    draft["blocks"] = {name: leaf[:n_layers]
                       for name, leaf in params["blocks"].items()}
    return dataclasses.replace(cfg, n_layers=n_layers), draft


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (see ROADMAP.md)")


def _check_ported(cfg: GPTConfig) -> None:
    """Raise for every config branch the port does not have yet."""
    if cfg.moe_layer_ids and cfg.moe_axis is not None:
        _unported("expert parallelism (moe_axis)")
    if cfg.ring_attention:
        _unported("ring attention")
    if cfg.n_stages > 1:
        _unported("pipeline stages (n_stages > 1)")


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def gpt_init(cfg: GPTConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random params with the JAX tree's keys, shapes and distributions
    (normal, std 0.02; the residual projections scaled by 1/sqrt(2L);
    wpe std 0.01; LayerNorm ones/zeros), drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (None: the
    card). The values differ from the JAX package's ``gpt_init``.

    With ``moe_experts=E`` the dense MLP leaves stack the non-MoE layers
    only and ``params["moe"]`` (leading dim: the MoE layers) holds the
    router and expert weights, drawn after every dense leaf, so the
    dense leaves of a ``moe_experts=0`` config are unchanged."""
    _check_ported(cfg)
    dev = resolve_device(device)
    H, L, M, V, S = (cfg.hidden, cfg.n_layers, cfg.mlp_hidden,
                     cfg.vocab_size, cfg.seq_len)
    pd = cfg.param_dtype
    std = 0.02
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def nrm(shape, scale=std):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (scale * x).to(pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    moe_ids = cfg.moe_layer_ids
    Ld = L - len(moe_ids)                 # dense-MLP layer count
    blocks = {
        "ln1_s": ones((L, H)),
        "ln1_b": zeros((L, H)),
        "qkv_w": nrm((L, H, 3 * H)),
        "qkv_b": zeros((L, 3 * H)),
        "proj_w": nrm((L, H, H), std / math.sqrt(2 * L)),
        "proj_b": zeros((L, H)),
        "ln2_s": ones((L, H)),
        "ln2_b": zeros((L, H)),
        "fc_w": nrm((Ld, H, M)),
        "fc_b": zeros((Ld, M)),
        "out_w": nrm((Ld, M, H), std / math.sqrt(2 * L)),
        "out_b": zeros((Ld, H)),
    }
    out = {
        "wte": nrm((V, H)),
        "wpe": nrm((S, H), 0.01),
        "blocks": blocks,
        "lnf_s": ones((H,)),
        "lnf_b": zeros((H,)),
    }
    if moe_ids:
        Lm, E = len(moe_ids), cfg.moe_experts
        out["moe"] = {
            "router_w": nrm((Lm, H, E)),
            "w_in": nrm((Lm, E, H, M)),
            "b_in": zeros((Lm, E, M)),
            "w_out": nrm((Lm, E, M, H), std / math.sqrt(2 * L)),
            "b_out": zeros((Lm, E, H)),
        }
    return out


def _tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr)   # a writable copy (JAX hands out read-only views)
    if arr.dtype.name == "bfloat16":
        # torch.from_numpy has no bfloat16: carry the bits as uint16
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree, device=None):
    """The JAX ``gpt_init`` pytree, given as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's params: the
    same keys, shapes and values (the MoE ``moe`` subtree included), on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree, dev)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _attention(cfg: GPTConfig, q, k, v):
    if cfg.ring_attention:
        _unported("ring attention")
    return flash_attention_arrays(q, k, v, causal=True,
                                  scale=1.0 / math.sqrt(cfg.head_dim))


def _mm(x, w, cd):
    """x @ w in the compute dtype. int8-quantized dict weights feed the
    decode steps only (:func:`_dec_mm`)."""
    if isinstance(w, dict):
        _unported("int8 weights outside the decode steps "
                  "(quantize_gpt_weights feeds gpt_decode_step only)")
    return x @ w.to(cd)


def _attn_half(cfg: GPTConfig, p, x):
    """Attention half of a block (LN1 → QKV → attention → proj +
    residual); p leaves have no layer dim. Returns (x, (kh, vh)), each
    (B, nh, S, hd) contiguous."""
    B, S, H = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    cd = cfg.dtype

    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    qkv = _mm(h, p["qkv_w"], cd) + p["qkv_b"].to(cd)
    q, k, v = qkv.split(H, dim=-1)

    def to_heads(t):
        return t.reshape(B, S, nh, hd).transpose(1, 2).contiguous()

    kh, vh = to_heads(k), to_heads(v)
    o = _attention(cfg, to_heads(q), kh, vh)
    o = o.transpose(1, 2).reshape(B, S, H)
    return x + _mm(o, p["proj_w"], cd) + p["proj_b"].to(cd), (kh, vh)


def _composed_mlp(cfg: GPTConfig, p, x, mm):
    """LN2 → gelu MLP + residual as separate ops; ``mm`` is :func:`_mm`,
    or :func:`_dec_mm` where the weights may be int8-quantized."""
    cd = cfg.dtype
    h = _layer_norm(x, p["ln2_s"], p["ln2_b"])
    h = F.gelu(mm(h, p["fc_w"], cd) + p["fc_b"].to(cd), approximate="tanh")
    return x + mm(h, p["out_w"], cd) + p["out_b"].to(cd)


def _mlp_half(cfg: GPTConfig, p, x):
    """Dense MLP half of a block (LN2 → gelu MLP + residual). With
    ``fp8`` (None follows FLAGS_fp8_matmul) both matmuls go through
    ``fp8_linear``, their weights cast to the compute dtype before they
    are quantized and the biases added outside the kernel; otherwise
    with ``fused_mlp`` (None follows FLAGS_fused_kernels) one fused
    LN-MLP call. fp8 wins when both are on, as in JAX."""
    cd = cfg.dtype
    fp8 = cfg.fp8 if cfg.fp8 is not None else flags.fp8_matmul[0]
    fused = (cfg.fused_mlp if cfg.fused_mlp is not None
             else flags.fused_kernels[0])
    if (fp8 or fused) and (isinstance(p["fc_w"], dict)
                           or isinstance(p["out_w"], dict)):
        _unported("int8 weights outside the decode steps "
                  "(quantize_gpt_weights feeds gpt_decode_step only)")
    if fp8:
        h = _layer_norm(x, p["ln2_s"], p["ln2_b"])
        h = F.gelu(fp8_linear(h, p["fc_w"].to(cd), p["fc_b"].to(cd)),
                   approximate="tanh")
        return x + fp8_linear(h, p["out_w"].to(cd), p["out_b"].to(cd))
    if fused:
        return fused_ln_mlp(x, p["fc_w"].to(cd), p["fc_b"].to(cd),
                            p["out_w"].to(cd), p["out_b"].to(cd),
                            ln_scale=p["ln2_s"], ln_bias=p["ln2_b"],
                            residual=True, act="gelu")
    return _composed_mlp(cfg, p, x, _mm)


def _block(cfg: GPTConfig, p, x):
    """One transformer block without its K/V, so a training stack keeps
    no layer's K/V alive beyond what the attention's backward saves."""
    x, _ = _attn_half(cfg, p, x)
    return _mlp_half(cfg, p, x)


def _moe_mlp_half(cfg: GPTConfig, p, pm, x, capacity_factor):
    """MoE MLP half (LN2 → routed expert FFN + residual). x (B, S, H);
    returns (x, aux, z, counts (E,), dropped). Dropped assignments add
    nothing to y, so the residual passes those tokens through."""
    B, S, H = x.shape
    h = _layer_norm(x, p["ln2_s"], p["ln2_b"])
    y, aux, z, counts, dropped = moe_ffn(
        pm, h.reshape(B * S, H), top_k=cfg.moe_top_k,
        capacity_factor=capacity_factor, expert_axis=cfg.moe_axis)
    return x + y.reshape(B, S, H), aux, z, counts, dropped


def _block_moe(cfg: GPTConfig, p, pm, x, capacity_factor):
    """One MoE transformer block (attention half + routed MLP half)."""
    x, _ = _attn_half(cfg, p, x)
    return _moe_mlp_half(cfg, p, pm, x, capacity_factor)


def _embed(cfg: GPTConfig, params, tokens):
    emb = params["wte"].to(cfg.dtype)[tokens]
    pos = params["wpe"].to(cfg.dtype)[: tokens.shape[1]]
    return emb + pos[None, :, :]


def _logits(params, x, compute_dtype=torch.bfloat16):
    # tied head: bf16 operands, f32 accumulation, f32 logits (the JAX
    # einsum with preferred_element_type=f32). A product of two bf16
    # values is exact in f32, so an f32 matmul of the bf16-rounded
    # operands is that same computation; its backward rounds the
    # cotangents of x and the weight to bf16, as jax.grad does.
    w = params["wte"].to(compute_dtype).float()
    return x.to(compute_dtype).float() @ w.t()


def _head(cfg: GPTConfig, params, x):
    x = _layer_norm(x, params["lnf_s"], params["lnf_b"])
    return _logits(params, x)


_ATTN_KEYS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
              "ln2_s", "ln2_b")
_MLP_KEYS = ("fc_w", "fc_b", "out_w", "out_b")


def _unbind(tree):
    return {k: (_unbind(v) if isinstance(v, dict) else v.unbind(0))
            for k, v in tree.items()}


def _row(cols, i):
    return {k: (_row(v, i) if isinstance(v, dict) else v[i])
            for k, v in cols.items()}


def _unstack(cfg: GPTConfig, params):
    """Per-layer params ``[(p, pm), ...]`` for the ``n_layers`` blocks:
    ``p`` the layer's attention/LN leaves plus, on a dense layer, its MLP
    leaves; ``pm`` the MoE layer's router and expert leaves, or None.
    Attention leaves stack L layers, dense MLP leaves the non-MoE layers
    and ``params["moe"]`` the MoE layers. The views are taken with one
    ``unbind`` per leaf: its backward stacks every layer's gradient in
    one op, where indexing layer by layer would add each layer's
    gradient into a zero-filled full-size (L, ...) buffer (L full
    passes per leaf)."""
    blocks = _unbind(params["blocks"])
    moe_ids = set(cfg.moe_layer_ids)
    if not moe_ids:
        return [(_row(blocks, i), None) for i in range(cfg.n_layers)]
    attn = {k: blocks[k] for k in _ATTN_KEYS}
    mlp = {k: blocks[k] for k in _MLP_KEYS}
    moe = _unbind(params["moe"])
    out, di, mi = [], 0, 0
    for i in range(cfg.n_layers):
        if i in moe_ids:
            out.append((_row(attn, i), _row(moe, mi)))
            mi += 1
        else:
            out.append(({**_row(attn, i), **_row(mlp, di)}, None))
            di += 1
    return out


def _hidden(cfg: GPTConfig, params, x, capacity_factor=None):
    """The block stack: (x, aux, z), aux and z the router losses SUMMED
    over the MoE layers (None for a dense model). ``capacity_factor``
    None routes droplessly (inference). With ``cfg.remat`` each block is
    a non-reentrant checkpoint (its activations are recomputed in the
    backward), the counterpart of ``jax.checkpoint``."""
    _check_ported(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = zl = None
    for p, pm in _unstack(cfg, params):
        if pm is None:
            x = (checkpoint(_block, cfg, p, x, use_reentrant=False) if remat
                 else _block(cfg, p, x))
            continue
        args = (cfg, p, pm, x, capacity_factor)
        x, a, z, _, _ = (checkpoint(_block_moe, *args, use_reentrant=False)
                         if remat else _block_moe(*args))
        aux = a if aux is None else aux + a
        zl = z if zl is None else zl + z
    return x, aux, zl


def _stack(cfg: GPTConfig, params, x):
    """Block stack for the prefill (MoE layers dropless); returns
    (x, ks, vs) with one (B, nh, S, hd) K/V per layer."""
    _check_ported(cfg)
    ks, vs = [], []
    for p, pm in _unstack(cfg, params):
        x, (kh, vh) = _attn_half(cfg, p, x)
        if pm is None:
            x = _mlp_half(cfg, p, x)
        else:
            x = _moe_mlp_half(cfg, p, pm, x, None)[0]
        ks.append(kh)
        vs.append(vh)
    return x, ks, vs


def gpt_forward(cfg: GPTConfig, params, tokens):
    """tokens (B, S) int → logits (B, S, V) f32; differentiable. MoE
    blocks route droplessly here (inference semantics)."""
    x, _, _ = _hidden(cfg, params, _embed(cfg, params, tokens))
    return _head(cfg, params, x)


def _chunk_nll(wte, xs, ls, compute_dtype):
    """Summed negative log-likelihood of one sequence chunk. The tied
    weight is cast inside the chunk, as the JAX scan body does, so each
    chunk's weight cotangent is rounded to the compute dtype before the
    chunks are summed."""
    logp = torch.log_softmax(_logits({"wte": wte}, xs, compute_dtype),
                             dim=-1)
    return -logp.gather(-1, ls[..., None]).sum()


def _chunked_ce(params, x, labels, chunk: int,
                compute_dtype=torch.bfloat16):
    """Cross entropy without materializing (B, S, V) logits: the final
    LN'd hiddens go through the head in sequence chunks, each chunk a
    checkpoint whose (B, chunk, V) logits are recomputed in the backward,
    so peak memory holds one chunk's logits."""
    B, S, _ = x.shape
    total = sum(checkpoint(_chunk_nll, params["wte"], x[:, c:c + chunk],
                           labels[:, c:c + chunk], compute_dtype,
                           use_reentrant=False)
                for c in range(0, S, chunk))
    return total / (B * S)


def gpt_loss(cfg: GPTConfig, params, batch, n_micro: int = 1,
             loss_chunk: Optional[int] = None):
    """Causal-LM cross entropy (a 0-dim f32 tensor, differentiable with
    respect to every param). batch = (tokens, labels), both (B, S) int.

    ``loss_chunk``: sequence-chunked CE (:func:`_chunked_ce`), the peak
    memory saver for a large vocabulary; it must divide S. MoE configs
    route with ``moe_capacity_factor`` (drops pass the residual through)
    and add ``moe_aux_weight · mean-layer aux + moe_z_weight ·
    mean-layer z`` to the CE. ``n_stages == 1`` only (the pipeline
    raises ``NotImplementedError``); ``n_micro`` is the pipeline's and
    is unused here."""
    tokens, labels = batch
    dev = params["wte"].device
    tokens = torch.as_tensor(tokens).to(dev, torch.long)
    labels = torch.as_tensor(labels).to(dev, torch.long)
    x, aux, zl = _hidden(cfg, params, _embed(cfg, params, tokens),
                         cfg.moe_capacity_factor)
    x = _layer_norm(x, params["lnf_s"], params["lnf_b"])
    S = tokens.shape[1]
    if loss_chunk and S > loss_chunk:
        if S % loss_chunk != 0:
            raise ValueError(
                f"loss_chunk={loss_chunk} must divide seq_len={S} (the "
                "memory saver would otherwise be silently disabled)")
        ce = _chunked_ce(params, x, labels, loss_chunk)
    else:
        logp = torch.log_softmax(_logits(params, x), dim=-1)
        ce = -logp.gather(-1, labels[..., None])[..., 0].mean()
    if aux is not None:
        n = len(cfg.moe_layer_ids)
        ce = ce + cfg.moe_aux_weight * (aux / n) \
            + cfg.moe_z_weight * (zl / n)
    return ce


# --------------------------------------------------------------------------
# KV-cache serving path
# --------------------------------------------------------------------------

def prefill_hidden(cfg: GPTConfig, params, tokens):
    """gpt_prefill before the head: (hidden (B, S, H), (k, v)), k/v
    (B, L, nh, S, hd). The engine takes the logits of one row only."""
    x, ks, vs = _stack(cfg, params, _embed(cfg, params, tokens))
    return x, (torch.stack(ks, dim=1), torch.stack(vs, dim=1))


def gpt_prefill(cfg: GPTConfig, params, tokens):
    """tokens (B, S) int → (logits (B, S, V) f32, (k, v)), k/v each
    (B, L, nh, S, hd) in cfg.dtype: the K/V gpt_forward computes, slot
    major, ready for serving.kv_cache.cache_insert."""
    x, kv = prefill_hidden(cfg, params, tokens)
    return _head(cfg, params, x), kv


def quantize_gpt_weights(params, names=("qkv_w", "proj_w", "fc_w",
                                        "out_w")):
    """Per-channel int8 weight quantization of the block matmuls.

    Each named (L, K, N) block weight becomes ``{"q": int8 (L, K, N),
    "s": f32 (L, N)}``: s = max(|w| over K, 1e-8) / 127 from the f32
    master weight, q = round(w / s) (half to even) clipped to ±127. The
    tree feeds :func:`gpt_decode_step` / :func:`gpt_decode_step_paged`
    only; embeddings and the head stay fp. Returns a new tree on the
    params' device; the other leaves are the caller's tensors."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in names:
        w = blocks[name].float()
        s = _quant_scale(w.abs().amax(dim=1))
        blocks[name] = {"q": _quantize(w, s[:, None, :]), "s": s}
    out["blocks"] = blocks
    return out


def _dec_mm(x, w, cd):
    """x @ w for a maybe-int8-quantized decode weight: a ``{"q", "s"}``
    dict goes through the int8 matmul with dynamic per-tensor activation
    quantization."""
    if isinstance(w, dict):
        return dynamic_int8_matmul(x, w["q"], w["s"]).to(cd)
    return x @ w.to(cd)


def _dec_attn(cfg: GPTConfig, p, x, kc_l, vc_l, positions):
    """Attention half of the one-token block step. x (B, 1, H); kc_l/vc_l
    (B, nh, max_len, hd) views of one layer of the cache, written in
    place at ``positions`` (B,). Returns (x, kc_l, vc_l)."""
    B = x.shape[0]
    nh, hd, H = cfg.n_heads, cfg.head_dim, cfg.hidden
    cd = cfg.dtype

    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    qkv = _dec_mm(h, p["qkv_w"], cd) + p["qkv_b"].to(cd)
    q, k, v = (t.reshape(B, nh, hd) for t in qkv.split(H, dim=-1))

    pos = positions.long()
    lanes = torch.arange(B, device=x.device)
    # in place: the JAX step returns a new cache that the engine donates
    kc_l[lanes, :, pos] = k.to(kc_l.dtype)
    vc_l[lanes, :, pos] = v.to(vc_l.dtype)

    # scores in the compute dtype, softmax in f32; positions past each
    # slot's write position (padding, a previous occupant) are masked
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhd,bhkd->bhk", q, kc_l) * scale
    live = torch.arange(kc_l.shape[2], device=x.device)[None, :] \
        <= pos[:, None]
    s = torch.where(live[:, None, :], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhk,bhkd->bhd", w, vc_l).reshape(B, 1, H)

    x = x + _dec_mm(o, p["proj_w"], cd) + p["proj_b"].to(cd)
    return x, kc_l, vc_l


def _dec_layers(cfg: GPTConfig, params, x, attn, mm=_dec_mm):
    """The block stack shared by the decode, verify and chunk steps:
    ``attn(i, p, x)`` is layer i's attention half; a dense MLP half is
    always composed (as in JAX, whatever ``fused_mlp`` says) through
    ``mm`` (:func:`_dec_mm` takes int8-quantized dicts). Returns (x,
    moe_stats), the stats ``(counts (E,) int32, dropped int32)`` summed
    over the MoE layers (None for a dense model); MoE layers route
    droplessly, so decode never depends on which requests share the
    tick."""
    stats = None
    for i, (p, pm) in enumerate(_unstack(cfg, params)):
        x = attn(i, p, x)
        if pm is None:
            x = _composed_mlp(cfg, p, x, mm)
            continue
        x, _, _, c, d = _moe_mlp_half(cfg, p, pm, x, None)
        stats = (c, d) if stats is None else (stats[0] + c, stats[1] + d)
    return x, stats


def _dec_embed(cfg: GPTConfig, params, positions, tokens):
    cd = cfg.dtype
    return (params["wte"].to(cd)[tokens.long()]
            + params["wpe"].to(cd)[positions.long()])[:, None, :]


def gpt_decode_step(cfg: GPTConfig, params, cache, positions, tokens):
    """Batched one-token decode against a slotted KV cache.

    cache = (k, v), each (B, L, nh, max_len, hd); positions (B,) int —
    where each slot's incoming token lands; tokens (B,) int. Returns
    (logits (B, V) f32, cache) with the new K/V written in place at
    ``positions``. Stale slots compute garbage that a later prefill
    overwrites. MoE configs return a third element ``(counts (E,)
    int32, dropped int32)``, the tick's router load summed over the MoE
    layers (dropless routing: dropped stays 0)."""
    _check_ported(cfg)
    k_cache, v_cache = cache
    x = _dec_embed(cfg, params, positions, tokens)
    x, stats = _dec_layers(
        cfg, params, x, lambda i, p, x: _dec_attn(
            cfg, p, x, k_cache[:, i], v_cache[:, i], positions)[0])
    out = (_head(cfg, params, x)[:, 0], (k_cache, v_cache))
    return out if stats is None else out + (stats,)


def _no_moe(cfg: GPTConfig, what: str) -> None:
    if cfg.moe_layer_ids:
        raise ValueError(
            f"{what} does not support MoE configs (the engine rejects "
            "speculative decoding and prefix caching with moe_experts > 0)")


def _verify_embed(cfg: GPTConfig, params, positions, tokens):
    """(B, C, H) embeddings of C tokens per row, token j of row b at
    position ``positions[b] + j``; returns (x, qpos (B, C) int64)."""
    cd = cfg.dtype
    qpos = positions.long()[:, None] \
        + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return params["wte"].to(cd)[tokens.long()] \
        + params["wpe"].to(cd)[qpos], qpos


def _verify_attend(cfg: GPTConfig, p, x, q, kc, vc, qpos, mm=_dec_mm):
    """Composed multi-query attention of a verify block: q (B, nh, C,
    hd) over kc/vc (B, nh, T, hd), query j of row b masked to keys at
    ``pos <= qpos[b, j]``; scores in the compute dtype, softmax in f32.
    Returns x plus the projected attention output (B, C, H)."""
    B, nh, C, hd = q.shape
    cd = cfg.dtype
    s = torch.einsum("bhqd,bhkd->bhqk", q, kc.to(q.dtype)) \
        * (1.0 / math.sqrt(hd))
    live = torch.arange(kc.shape[2], device=x.device)[None, None, :] \
        <= qpos[:, :, None]
    s = torch.where(live[:, None], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w, vc.to(q.dtype))
    o = o.transpose(1, 2).reshape(B, C, nh * hd)
    return x + mm(o, p["proj_w"], cd) + p["proj_b"].to(cd)


def _verify_qkv(cfg: GPTConfig, p, x, mm=_dec_mm):
    """LN1 → QKV of a verify block; each (B, C, nh, hd)."""
    B, C, H = x.shape
    cd = cfg.dtype
    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    qkv = mm(h, p["qkv_w"], cd) + p["qkv_b"].to(cd)
    return (t.reshape(B, C, cfg.n_heads, cfg.head_dim)
            for t in qkv.split(H, dim=-1))


def _block_verify(cfg: GPTConfig, p, x, kc_l, vc_l, qpos):
    """Attention half of the C-token block step against one layer of the
    slotted cache: kc_l/vc_l (B, nh, max_len, hd) views, the C new K/V
    rows of row b written in place at ``qpos[b]``; query j attends over
    the slot masked to ``pos <= qpos[b, j]`` — per query the math of the
    one-token step run token by token."""
    q, k, v = _verify_qkv(cfg, p, x)
    lanes = torch.arange(x.shape[0], device=x.device)[:, None]
    kc_l[lanes, :, qpos] = k.to(kc_l.dtype)
    vc_l[lanes, :, qpos] = v.to(vc_l.dtype)
    return _verify_attend(cfg, p, x, q.transpose(1, 2), kc_l, vc_l, qpos)


def gpt_verify_step(cfg: GPTConfig, params, cache, positions, tokens):
    """Batched MULTI-token decode against a slotted KV cache.

    cache = (k, v), each (B, L, nh, max_len, hd); positions (B,) int —
    where each row's FIRST token lands (token j at ``positions + j``);
    tokens (B, C) int. Returns (logits (B, C, V) f32, cache): logits[:,
    j] is the next-token distribution after consuming tokens ``[..j]``,
    what gpt_decode_step returns fed the same tokens one at a time — the
    speculative-decoding verify pass, and the draft cache's chunk
    append. The caller guarantees ``positions + C <= max_len``; rejected
    rows leave stale K/V past the accepted length, which the position
    mask hides until a later step overwrites them."""
    _no_moe(cfg, "gpt_verify_step")
    k_cache, v_cache = cache
    x, qpos = _verify_embed(cfg, params, positions, tokens)
    x, _ = _dec_layers(cfg, params, x, lambda i, p, x: _block_verify(
        cfg, p, x, k_cache[:, i], v_cache[:, i], qpos))
    return _head(cfg, params, x), (k_cache, v_cache)


# --------------------------------------------------------------------------
# paged KV cache variants
# --------------------------------------------------------------------------

def _dec_attn_paged(cfg: GPTConfig, p, x, kb, vb, layer, tables, positions):
    """Attention half of the paged one-token block step. kb/vb are the
    WHOLE pool (n_blocks, L, nh, bs, hd): the new K/V row is stored in
    place at (its block, ``layer``, its offset), and the paged kernel
    reads layer ``layer`` of the pool where it lies — no per-layer copy.
    tables (B, W) int32; positions (B,) int32. Returns (x, kb, vb)."""
    B = x.shape[0]
    nh, hd, H = cfg.n_heads, cfg.head_dim, cfg.hidden
    bs = kb.shape[3]
    cd = cfg.dtype

    h = _layer_norm(x, p["ln1_s"], p["ln1_b"])
    qkv = _dec_mm(h, p["qkv_w"], cd) + p["qkv_b"].to(cd)
    q, k, v = (t.reshape(B, nh, hd) for t in qkv.split(H, dim=-1))

    # slots own their blocks exclusively, so the only index collisions
    # are stale lanes colliding on garbage block 0
    pos = positions.long()
    blk = tables.long().gather(1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    kb[blk, layer, :, off] = k.to(kb.dtype)
    vb[blk, layer, :, off] = v.to(vb.dtype)

    o = paged_attention_arrays(q.contiguous(), kb, vb, tables,
                               positions + 1, scale=1.0 / math.sqrt(hd),
                               layer=layer)
    x = x + _dec_mm(o.reshape(B, 1, H), p["proj_w"], cd) \
        + p["proj_b"].to(cd)
    return x, kb, vb


def gpt_decode_step_paged(cfg: GPTConfig, params, pool, tables, positions,
                          tokens):
    """Batched one-token decode against a paged block pool.

    pool = (kb, vb), each (n_blocks, L, nh, block_size, hd); tables
    (B, W) int32 per-slot block tables (padding and stale rows point at
    block 0); positions/tokens (B,) int32. Returns (logits (B, V) f32,
    pool) with each new K/V written in place at block
    ``tables[b, positions[b] // block_size]``, offset
    ``positions[b] % block_size``. MoE configs return the same third
    ``(counts, dropped)`` element gpt_decode_step does."""
    _check_ported(cfg)
    kb, vb = pool
    x = _dec_embed(cfg, params, positions, tokens)
    x, stats = _dec_layers(
        cfg, params, x, lambda i, p, x: _dec_attn_paged(
            cfg, p, x, kb, vb, i, tables, positions)[0])
    out = (_head(cfg, params, x)[:, 0], (kb, vb))
    return out if stats is None else out + (stats,)


def _paged_attend(cfg: GPTConfig, p, x, kb, vb, layer, rows, where, qpos,
                  mm):
    """Attention half of every multi-token step against the WHOLE pool
    (n_blocks, L, nh, bs, hd) at layer ``layer`` — a prefill chunk (B = 1)
    and the paged verify alike: token j of row b is stored in place at
    ``where = (block, offset)`` of position ``qpos[b, j]`` through the
    table ``rows`` (B, W), so a row may start anywhere in a block; the
    queries then attend over the gathered table in composed math (the
    multi-query shape the decode kernel does not cover), masked to
    ``pos <= qpos``. Stale lanes scatter onto the garbage sink, as in
    the one-token step. ``mm`` is :func:`_mm` or :func:`_dec_mm` (int8
    weights)."""
    B, C, _ = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    T = rows.shape[1] * kb.shape[3]
    q, k, v = _verify_qkv(cfg, p, x, mm)
    blk, off = where
    kb[blk, layer, :, off] = k.to(kb.dtype)
    vb[blk, layer, :, off] = v.to(vb.dtype)
    kg = kb[rows, layer].transpose(1, 2).reshape(B, nh, T, hd)
    vg = vb[rows, layer].transpose(1, 2).reshape(B, nh, T, hd)
    return _verify_attend(cfg, p, x, q.transpose(1, 2), kg, vg, qpos, mm)


def _paged_hidden(cfg: GPTConfig, params, pool, tables, positions, tokens,
                  mm):
    """The multi-token block stack over the pool: hidden (B, C, H), the
    pool written in place. The tokens' pool addresses are found once for
    all layers. A MoE layer routes droplessly."""
    kb, vb = pool
    bs = kb.shape[3]
    x, qpos = _verify_embed(cfg, params, positions, tokens)
    rows = tables.long()
    where = (rows.gather(1, qpos // bs), qpos % bs)
    x, _ = _dec_layers(cfg, params, x, lambda i, p, x: _paged_attend(
        cfg, p, x, kb, vb, i, rows, where, qpos, mm), mm)
    return x


def prefill_chunk_hidden(cfg: GPTConfig, params, pool, table_row, tokens,
                         start):
    """gpt_prefill_chunk before the head: the chunk's hidden states
    (1, C, H); the pool is written in place."""
    _check_ported(cfg)
    start = torch.tensor([int(start)], device=tokens.device)
    return _paged_hidden(cfg, params, pool, table_row[None], start, tokens,
                         _mm)


def gpt_prefill_chunk(cfg: GPTConfig, params, pool, table_row, tokens,
                      start):
    """One chunk of a paged, chunked prefill.

    tokens (1, C) int — the next C prompt tokens (end padding lands in
    the slot's own blocks and is overwritten before it is attended);
    start — tokens already cached for this slot, which need NOT be
    block-aligned (a radix prefix match ends wherever the prompts
    diverge); table_row (W,) int32 must already cover positions
    < start + C. Token j lands at ``start + j`` through the table's
    block/offset lookup and attends over the whole cached prefix masked
    to ``pos <= start + j``. Returns (logits (1, C, V) f32, pool):
    logits at position i equal gpt_prefill's at global position
    start + i."""
    x = prefill_chunk_hidden(cfg, params, pool, table_row, tokens, start)
    return _head(cfg, params, x), pool


# the radix prefix cache's tail entry point (the JAX name): a chunk at an
# unaligned start
gpt_prefill_prefix = gpt_prefill_chunk


def gpt_verify_step_paged(cfg: GPTConfig, params, pool, tables, positions,
                          tokens):
    """Batched multi-token decode against a paged block pool.

    pool = (kb, vb), each (n_blocks, L, nh, block_size, hd); tables
    (B, W) int32; positions (B,) int — the first token's index per row;
    tokens (B, C) int. Returns (logits (B, C, V) f32, pool). Same
    per-query math as gpt_decode_step_paged; the caller has grown each
    live row's table to cover ``positions + C`` tokens."""
    _no_moe(cfg, "gpt_verify_step_paged")
    x = _paged_hidden(cfg, params, pool, tables, positions, tokens, _dec_mm)
    return _head(cfg, params, x), pool
