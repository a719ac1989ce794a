#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line (every time is the card's own,
stamped with the card's name and power limit):

1. device: torch's device name and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel built from ``paddle_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with ptxas' register/spill lines;
   for the Hopper kernels (``csrc/hopper.cuh``: the fp8 matmul, the bf16
   flash forward and backward, and the bf16 LN-MLP forward and backward
   GEMMs of ``csrc/gemm_sm90.cuh``) each function's registers, spills
   and dynamic shared memory, and, where ``cuobjdump`` exists, the count
   of wgmma (HGMMA) and TMA load (UTMALDG) instructions in its SASS (none
   fails the run); the int8 matmul kernels' registers, spills and
   dynamic shared memory; the paged decode's (bulk copies) and the MoE
   gather's registers, spills, static and dynamic shared memory, and the
   paged decode clusters the card holds at once;
3. flash-attention forward vs its plain PyTorch version, causal, bf16
   and f32, at gpt_1p3b prefill shapes (1, 16, S, 128) for S in 16, 128
   (the bucket of a 100-token prompt), 2048, and at one gpt_small shape
   (1, 12, 1024, 64); bf16 only at the training shape (4, 16, 2048,
   128), a non-causal (1, 12, 512, 64) and a ragged causal Sq 100 /
   Sk 612: max |Δo|, max |Δlse|, kernel / plain /
   scaled_dot_product_attention / bound times and the kernel's ratio
   to the library call, each of the kernel's and the library's times
   taken both around a lone call (``ms``) and per call of 20 issued back
   to back (``batch_ms``);
4. paged-attention decode vs its plain version at B=8, nh=16, hd=128,
   bs=16, W=128 over a 24-layer pool, ragged lengths with stale
   sink-only lanes (bf16 and f32), and 8 slots of ~1040 tokens (bf16);
   ``ragged`` True and False bit-identical, length 0 gives zeros, one
   launch a call (the wrapper's count and the profiler's kernels); the
   lone call's time (``ms``) and the kernel's own device time
   (torch.profiler) after a flush that leaves the L2 dirty
   (``kernel_ms``), warm and clean (``kernel_ms_warm``, ``_clean``);
5. the serving engine at full gpt_1p3b width and depth (random weights
   from a seed), fixed slots and paged: 8 greedy requests with prompts
   of 40 to 1500 tokens and 2 sampled ones, 32 new tokens each; every
   request must finish with valid tokens, each kernel's launch count
   must rise during its mode's run, and a sampled request replayed on a
   fresh engine must give the same tokens; prints prefill ms, decode
   tokens/s and peak memory;
6. paged decode logits vs fixed-slot decode logits on one shared state
   at full width in f32 (the kernel path against the composed path);
7. flash-attention backward vs its plain version, causal, bf16 and f32,
   at the training shape (4, 16, 2048, 128), a ragged (1, 16, 100, 128)
   and gpt_small's (1, 12, 1024, 64): max |Δdq|, |Δdk|, |Δdv|, kernel /
   plain / scaled_dot_product_attention-backward / bound times, the
   kernel's and the library's also per call of 20 back to back
   (``batch_ms``), and their ratios;
8. fused LN-MLP forward and backward (and the dW2 kernel alone) vs their
   plain versions, gelu, bf16 and f32, at one gpt_1p3b layer
   (R = 8192, H = 2048, M = 8192) and a ragged R = 100: errors, kernel /
   plain / bound times, the composed cuBLAS MLP's forward and backward
   times as a yardstick, the route of each (``fwd_kernel``,
   ``bwd_kernel``), each forward and backward kernel's own device time
   from one torch.profiler pass (``fwd_kernels_ms``,
   ``bwd_kernels_ms``); in bf16 also the forward for relu and swiglu
   (``fwd_other_acts``: errors, times, kernels);
9. training at full gpt_1p3b width and depth (remat, fused MLP, random
   weights from a seed) through DistributedTrainStep: AdamW at lr 1e-4,
   batch 4 x 2048, loss_chunk 256, 6 steps on one repeated batch; every
   loss and grad norm finite, the last loss below the first, every
   training kernel's launch count rising; step ms, tokens/s, model
   FLOP/s share and peak memory;
10. one step's loss and every gradient at full gpt_1p3b width and 2
    layers, f32, fused MLP, batch 1 x 256, on the card (the kernels)
    against the CPU (the plain versions): max relative error per leaf;
11. the fused AdamW and LAMB kernels against their plain versions
    (bit-identical) on a bucket of every gpt_1p3b parameter leaf (f32
    params and moments, then bf16 moments) and on a small ragged bucket
    with an unaligned leaf: kernel / plain / torch._fused_adamw_ / bound
    (28 bytes per f32 parameter) times;
12. training with FLAGS_fused_optimizer=1: phase 9's configuration, seed
    and batch with AdamW through the fused kernel (the first loss equal
    to phase 9's, each later one within TRAIN_LOSS_REL of it; step ms,
    tokens/s, peak memory); then LAMB, fused against pure, at full width
    and 2 layers for 3 steps fed the same gradients: max relative error
    per param leaf;
13. the int8 matmul kernel against its plain version (bit-identical) at
    M = 8 and M = 1 for each gpt_1p3b decode (K, N), and at ragged
    shapes with a bias, per-row scales, f32 output and a K that takes
    the kernel two passes: the lone call's time (``ms``), the kernel's
    own device time (``kernel_ms``, torch.profiler), plain and bound
    times, torch._int_mm (rows padded to 32) and a bf16 matmul as
    yardsticks, and ``batch_ms`` (20 calls back to back); and the
    quantizing entry (``dynamic_int8_matmul`` on bf16 activations,
    bit-identical to its plain version: its quantizing kernel, then the
    product behind it) beside the composed quantization plus the kernel;
    each entry's launches a call (the run fails on more than one, or two
    with quantization);
14. the engine phase again with int8_weights=True, fixed and paged: the
    same checks (but the sampled replay is held against a second lone
    replay: the per-tensor activation scale spans every slot of a tick,
    so an int8 stream depends on its batch), the int8 kernel's launches,
    and the share of greedy tokens equal to the bf16 run's
    (informational);
15. one int8 decode step at full gpt_1p3b width, 2 layers, f32, on the
    card (the kernels) against the CPU (the plain versions);
16. the fp8 (e4m3) matmul kernel against its plain version at the fp8
    training shapes (8192, 2048, 8192) and (8192, 8192, 2048) with the
    weight column-major (read in place) and row-major (transposed in the
    call), a 1500-row prefill (2048, 8192), a ragged (1000, 2048, 1000),
    a ragged (100, 64, 192) with a bias and a (100, 100, 192) whose K is
    zero-padded to 112, out bf16 and f32: errors, kernel / plain / bound
    times, torch._scaled_mm's time, error and the kernel's ratio to it
    (lone call and back to back, as in phase 3); and the STE backward's
    bf16 GEMM with f32 output against the f32 GEMM it replaces;
17. phase 9's training again with fp8=True (the fp8 MLP wins over the
    fused one): every loss within FP8_TRAIN_LOSS_REL of phase 9's, the
    fp8 kernel's launches per step, step ms, tokens/s, peak memory;
18. an fp8 training step's loss and gradients and the prefill's logits
    at full width, 2 layers, f32, on the card against the CPU, with the
    share of e4m3 activation codes that differ;
19. the MoE dispatch gather against its plain version (bit-identical)
    at the decode (8 tokens, 64 slots), training (8192 tokens, 20480
    slots) and a ragged (H = 100, f32) shape, with the src of a real
    top-2 routing: kernel / plain / torch.index_select times (lone
    calls), the gather's and index_select's kernels alone
    (``kernel_ms``, ``library_kernel_ms``, torch.profiler, after a dirty
    flush, with the records a call the trace kept; ``_clean`` after a
    clean one), and the bound from the distinct live source rows (one
    read each) and the slots;
20. the engine phase with gpt_1p3b(moe_experts=8) (top-2, every 2nd
    layer: 12 MoE layers, ~4.1B parameters, dropless serving) in both
    cache modes: phase 5's requests and checks, the gather's launches,
    the moe_expert_load gauge and no dropped assignment;
21. one MoE decode step and one training step at full width, 2 layers
    (1 MoE), f32, on the card against the CPU: identical routing
    (slots, src), logits and gradients within phase 6's and phase 10's
    tolerances;
22. MoE training at full width and 8 layers (4 MoE; 24 layers would
    need ~66 GB for f32 params, grads and AdamW moments alone): phase
    9's batch, remat, AdamW, 6 steps, finite and falling losses, the
    gather's launches, step ms, tokens/s, peak memory;
23. the fused add-LayerNorm kernels (forward: out, mu, rstd; backward:
    dx, ds, db) against their plain versions at BERT-base's (16384, 768)
    in f32 and bf16, gpt_1p3b's (8192, 2048) bf16 and ragged (1000, 776)
    bf16 and (1000, 130) f32: errors, kernel / plain / bound times and
    the add + F.layer_norm yardstick (L2 flushed between calls; each
    wrapper call timed by CUDA events, its kernels alone by
    torch.profiler as ``*_kernel_ms``), and ptxas' registers and shared
    memory of every add-LN kernel;
24. BERT-base (hidden 768, 12 layers, 12 heads, FFN 3072, vocab 30592,
    seq 512, batch 32, f32, random weights from paddle.seed) trained
    through the Paddle API (``import paddle_tpu_torch as paddle``):
    eager AdamW(lr 1e-4, weight_decay 0.01), ``loss.backward();
    opt.step(); opt.clear_grad()``, 6 steps on one batch, (a) a composed
    nn.TransformerEncoder of post-LN layers with both flags 0, (b) the
    fused_multi_head_attention + fused_feedforward blocks built from
    (a)'s initial weights with FLAGS_fused_kernels=1 and
    FLAGS_fused_optimizer=1: both losses fall, (b)'s first loss within
    BERT_FIRST_LOSS_REL of (a)'s, the add-LN kernels 12 + 12 launches a
    step, step ms, device ms, tokens/s, peak memory and every kernel's
    launches, and one more step under torch.profiler (summed kernel
    time, the largest kernels);
25. the fused encoder at full width and 2 layers, f32, batch 2 x 512,
    one step on the card (the kernels) against the CPU (the plain
    versions): the loss and every parameter's gradient.

26. speculative decoding's identity: gpt_1p3b's full width at 4 layers,
    f32 with TF32 off, block matrices scaled x4 (so greedy tokens vary),
    8 slots, phase 5's greedy prompts, 32 new tokens: the engine with
    spec_k 4 gives the plain engine's greedy streams in both cache modes,
    with two ``gpt_truncate`` drafts: the target's own 4 layers, which
    agree with it, so nearly every tick emits a burst of k+1 tokens (at
    least SELF_DRAFT_MIN of the proposals accepted and of the rows'
    ticks bursts longer than one), and 2 layers, which mostly disagree;
    a stream that parts must part where the target's top-2 logit gap is
    below TIE_REL of the top logit;
27. phase 5's run again without and with that draft (bf16, full depth,
    both cache modes) in this one phase: decode tokens/s of each, the
    acceptance rate, the sampled replay, and the device kernels per tick
    of each (torch.profiler over 10 ticks of a live engine);
28. the radix prefix cache, paged: 8 prompts on one 1024-token prefix
    with 64-400-token tails (one keeps only the first 1000 prefix
    tokens: a copy-on-write), the first alone, then the rest at once;
    f32 (4 layers, as phase 26) greedy streams equal the cold engine's;
    bf16 at full depth: the seven's prefill ms with and without the
    cache, the hit rate, copy-on-writes, and a second pass with a
    161-block pool and one more prompt on another prefix that must evict
    tree leaves; after shutdown every refcount is the tree's own;
29. text and constraints (bf16, full depth, both cache modes): a
    ByteTokenizer over a literal merge list, ``submit(text=...)``, and
    the bounded regex ``(yes|no), [0-9]{1,3}\\.``: 4 greedy and 4 sampled
    streams each end with "stop" within 16 tokens, their bytes a full
    match of the DFA;
30. the serving watchdog (16 new tokens a request in phases 30-33):
    f32 at full width and 4 layers, fixed and paged, phase 5's mix with
    FLAGS_fault_inject=serving_nan@step=3: request 3 ends "watchdog"
    (WatchdogTripped), every other stream equals the unarmed engine's,
    one trip and one restart, a serving_watchdog_restart flight dump that
    parses; bf16 at full depth, one poisoned slot on each decode path
    (fixed, paged, int8 paged, speculative paged): its verdict False,
    every other slot's True, the restart's ms to the first replayed
    token, peak memory (the paged restart's beside unarmed runs'); the
    armed against the unarmed tick (ms in turns, launches a tick);
    max_restarts=0 fails every open request;
31. overload control, bf16 at full depth, paged, 2-layer draft: a
    controller held at rung 0 gives overload=None's greedy tokens, rung 1
    stops speculation, rung 2 prefills a 1500-token prompt in 16-token
    chunks instead of 64; brownout gauges, queue-wait and tick p50/p99;
32. KV streaming between two bf16 engines at full depth with the prefix
    cache: a 1024-token prompt's 64 blocks exported and imported (B's
    greedy stream equals A's), a 1500-token prompt streamed in 8-block
    chunks while A prefills it; bytes, ms and GB/s of each copy, B's hit
    rate and first-token ms against a cold prompt;
33. failover, crash and tracing: f32 at 4 layers, A evacuated mid-decode
    and every stream adopted by B, token-identical to an undisturbed run;
    fail_at_tick(2) crashes B (InjectedCrash, a flight dump, submit
    refused with the cause); a traced paged run's chrome trace holds one
    decode_step a tick and per request its decode_tick events, prefill
    chunks, one request_done and one "f" flow; bf16 ms a tick with
    tracing on and off;
34. the replica router under chaos (bench.py's serving_chaos mix: 20
    requests of 12-72 tokens, Poisson at ~24 rps, one in five with a
    0.4 s deadline; replica_crash on replica 0, a slow_tick storm on
    replica 1, conn_drop): f32 at 4 layers over two paged prefix-caching
    replicas, every completed stream equal to a fault-free engine's,
    every request with a finish reason, router_failovers >= 1,
    first-token p50/p99, serving_replicas_healthy 2 then 1; bf16 at
    full depth through the paged pair and a fixed-slot int8 pair:
    launches of the flash forward, paged decode (each replica) and int8
    matmul, tokens/s;
35. the replica supervisor (f32, 4 layers, 16 requests on one 512-token
    head): replica 0 crashes, the first respawn fails (spawn_fail), the
    second rejoins and re-warms the head, streams equal a fault-free
    engine's; the rejoined replica's first-token ms against a cold
    engine's; a forced rung scales up to 3, rung 0 drains the newest
    replica and its open stream migrates, equal to an undisturbed run;
36. the HTTP front end over a router of two bf16 paged replicas at full
    depth (byte tokenizer and vocabulary): completions JSON and SSE equal
    to engine-direct greedy text, chat on a shared system prompt (prefix
    hit rate > 0), /v1/models, /metrics parsed as Prometheus text (five
    histograms, frontend_* series), a 429 with Retry-After, a bounded
    regex ending "stop", first-token ms over HTTP and engine-direct;
37. LeNet through the Paddle surface (bench.py's bench_lenet: Adam 1e-3,
    f32, batch 256 of 1×28×28, seed 0), 6 eager steps: step ms (median
    of the last 3), samples/s, peak memory, every loss finite, the first
    loss against the port's CPU run of the same weights and batch;
38. ResNet-50 (bench.py's bench_resnet50 at full size: 1000 classes,
    batch 256 of 3×224×224, ``amp.decorate`` O2 bf16, the loss under
    ``auto_cast`` O2, Momentum 0.1 / 0.9), 6 eager steps: step ms,
    samples/s, peak memory, every loss finite, every batch-norm buffer
    moved; one more step under torch.profiler (device ms, idle share,
    device launches, the 8 largest device items); then resnet50 in f32
    at batch 2 on the card against the CPU with the same weights: the
    first loss, conv1's and fc's gradients, bn1's running statistics
    after one Momentum step. Neither phase runs a hand-written kernel
    (their launch counts are on the kernels line, 0 expected);
39. the cross-host serving fleet in one process (bench.py's
    _fleet_burst): a prefill-role and two decode-role HostAgents over
    real loopback RPC and a FileKVStore registry, connect_fleet, paged
    prefix-caching engines. (a) f32 at gpt_1p3b's width and 4 layers:
    12 requests of 40/72/24/56 tokens (even greedy, odd sampled) at 24
    req/s, one decode host closed abruptly mid-burst: every stream
    completes equal to a monolithic engine's (or parts at a near-tie),
    prefill routed >= 1, reroutes >= 1; (b) the same under a
    net_partition window between the router and one decode host
    (rpc_errors or the breaker gauge moved); (c) bf16 at full depth:
    phase 5's requests through the disaggregated path: first-token
    p50/p99, KV transfer ms, bytes and GB/s, decode tok/s, row 2's
    launches on each decode host; the first streamed block against a
    stop-and-copy for one cold 1500-token prompt, and that payload's
    byte path (card to host, codec, socket, host to card);
40. the fleet across processes: a prefill-role and a decode-role
    HostAgent, each a spawned process on the card (byte tokenizer, f32,
    4 layers at full width), the parent's connect_fleet router behind
    ServingFrontend; 6 text prompts POSTed to /v1/completions (SSE):
    every text equals a monolithic engine's, prefill routed > 0;
    first-token ms over HTTP, each host's peak memory and launches from
    its own report;
41. LeNet through ``paddle.Model`` (BASELINE config 1 as Paddle users
    write it: f32, batch 256, Adam 1e-3, FLAGS_fused_optimizer=1,
    FLAGS_fast_step=1): ``fit`` one epoch over a ``DataLoader`` of a
    ``TensorDataset`` of 60,000 seeded 1×28×28 images (shuffled; the
    last batch of 96 rows is a second capture), ``evaluate`` on 10,000,
    ``predict``, and ``save`` → ``load`` into a fresh ``Model`` whose
    predictions are bit-equal; fit's samples/s with the loader, the
    captured step's host ms a call and ms a step beside phase 37's eager
    step, "device" samples/s over 50 replays with one host read,
    captures, row 7's launches (one a replayed step), peak memory;
    gates: every loss finite, the params after 5 captured steps against
    the uncaptured step's and the FLAGS_fused_optimizer=0 step's, and a
    warm-up + cosine schedule with a global-norm clip over 10 captured
    steps against the uncaptured run (max |Δ| / max |p| ≤ 1e-6, cuDNN
    deterministic for the gates);
42. ResNet-50 through ``jit.TrainStep`` (phase 38's configuration): 3
    warm-up calls (the first eager, then the capture), 15 per-call steps
    each read with float(loss), 10 replays back to back with one read,
    one replay under torch.profiler (device ms, idle share, launches,
    the top items), beside phase 38's eager step; every loss finite,
    every batch-norm buffer moved, the first 3 losses within 1e-3 of
    the uncaptured step's from the same weights and batch, and the
    params' max |Δ| after them.
43. MobileNetV2 at full width (scale 1.0, 1000 classes) through
    ``jit.TrainStep`` with phase 42's recipe (O2 bf16, Momentum 0.1 /
    0.9, batch 256 of 3×224×224): 3 warm-up calls, 15 per-call steps,
    10 replays with one read, one profiled replay (device ms, idle
    share, the top items); samples/s, step ms, peak memory; every loss
    finite, every batch-norm buffer moved, the first 3 captured losses
    within 1e-3 of the uncaptured step's from the same weights and
    generator state (the classifier's Dropout(0.2) drawing in both), and
    5 replays at learning rate 0 on one batch giving at least two
    distinct losses (each replay draws fresh dropout masks);
43b. MobileNetV2, MobileNetV1, AlexNet, VGG-16 and ResNeXt-50 32x4d in
    f32 at batch 2 on the card against the CPU with the same weights
    (dropout off): the first loss (1e-5), the last linear layer's weight
    gradient against the CPU's f64 run by phase 38's ratio rule, the
    first batch norm's running statistics after one Momentum step;
44. a sweep of the tensor and activation surface: every function this
    slice added (tensor, paddle.linalg, the activation and common
    functionals), once on the card and once on the CPU port from the
    same numpy inputs ((64, 1024) f32, an (8, 32, 56, 56) image, 64 × 64
    matrices): outputs on the card in the CPU's dtype, f32 values within
    1e-5 (elementwise) or 1e-4 (reductions, linalg, resizing) of the
    largest value, index outputs exact, the differentiable ones'
    gradients too; the count swept and the worst errors on a line of
    their own. Phases 43–44 run no hand-written kernel (their launches
    read 0).
45. PaddleNLP's attention seq2seq at its IWSLT'15 en→vi widths
    (vocabularies 17,191 and 7,709, width 512, a 2-layer LSTM encoder
    reading ``sequence_length``, a decoder cell of two LSTMCells with
    input feeding and Luong attention, dropout 0.2, weights uniform in
    ±0.1) on seeded token ids, batches of 128 padded to 50, through
    ``jit.TrainStep`` (Adam 1e-3, ClipGradByGlobalNorm(5),
    FLAGS_fused_optimizer=1: row 7 launches inside the replayed step):
    the eager step's ms, then the captured one's per-call and replay ms,
    target tokens/s and samples/s, the graph pool's GiB, one profiled
    replay (launches, idle share, top items); the first 3 captured
    losses within 1e-6 of the uncaptured step's from the same weights
    and generator state; then a beam-10, 256-step decode of 128
    sentences with torch's sync debug mode at "error" (no host read
    inside), its ms, sentences/s, launches and idle share;
45b. the same model in f32 at batch 2, dropout 0, card against CPU: the
    first loss (1e-5 relative), every gradient (1e-4 of its largest), a
    32-step beam decode of both rows (the same sequences, scores within
    1e-4, or a near tie within 1e-5 where two decodes part);
46. the rest of ``paddle.nn`` card against CPU in f32 at realistic
    sizes: transposed convolutions, pool masks and ``max_unpool2d``
    (exact), group / instance / local response norms and SpectralNorm,
    every loss of the slice (ctc at T 100, B 16, 30 classes, labels of
    30), GRU / LSTM / SimpleRNN / BiRNN / RNN at 512 with
    ``sequence_length``, the Transformer decoder at Transformer-base width
    (and its 32-step incremental decode through ``gen_cache`` against
    the full causal pass, on both devices), the extension and sequence
    functions, ``PyLayer``, a beam decode; the random functions' moments
    on 10⁶ draws within 5 standard errors and their draws repeated after
    ``paddle.seed``; the worst error of each kind and the seconds.

Then the card's name and power limit as ``nvidia-smi`` gives them, one
JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits nonzero;
without a CUDA device the script exits 2 and prints no result.
"""
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

# published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): bf16 tensor cores, f32 outside the tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12, torch.float8_e4m3fn: 1979e12}
PEAK_BYTES = 3.35e12

FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-3)}
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# f32 decode logits, paged kernel vs composed attention: both heads
# round the hidden state to bf16 before the logits matmul, so a last-bit
# difference in the hidden state can move a logit by ~1e-4
LOGITS_TOL = 2e-3
# backward kernels vs their plain versions, max |Δ| / max |plain| per
# output: f32 sums (and dQ's atomics) in another order; bf16 with the
# same roundings at the same points, but an f32 sum in another order can
# cross a bf16 rounding boundary (3.9e-3 of a value)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FMLP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# phase 10, per leaf: both heads round the logits' operands and their
# cotangents to bf16 (as the JAX head does), so a last-bit difference
# upstream can flip one bf16 rounding: 3.9e-3 of one element of the
# tied embedding's gradient, far less of every other leaf's
TRAIN_GRAD_TOL = {"wte": 5e-3, "other": 1e-3}
# phase 12: fused against pure AdamW over 6 steps. The first loss is the
# same computation on the same params (exactly equal); later ones differ
# by the optimizers' last bits (the pure update folds lr * wd in double,
# the kernel in f32) and by the flash backward's dQ atomics, which sum in
# a different order on every run. Adam turns such noise in a near-zero
# gradient into a whole ±lr step, and the step after phase 9's gradient
# spike (norm ~73 at step 3) moved by 9.6e-4 in the first run. The loss
# falls by 1-4% a step, so 5e-3 stays below one step's move
TRAIN_LOSS_REL = 5e-3
# phase 12, LAMB fused vs pure fed the same gradients: the same f32
# operations in the same order
LAMB_PARAM_TOL = 1e-6
# phase 15: the activations on the card and the CPU agree up to f32
# summation order, which can move one quantized activation by one step
INT8_LOGITS_REL = 1e-2
# phase 16, fp8 kernel vs plain, max |Δ| / max |plain|: the products of
# two e4m3 values are exact in both, the f32 sums run in another order
# (the tensor cores' own, against cuBLAS's f32 GEMM): 1e-4 in f32; in bf16
# a sum in another order can cross one bf16 rounding (3.9e-3 of a value)
FP8_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# phase 17: fp8 against bf16 training, each loss relative to phase 9's
# (the bound of tests/test_fp8.py's 50-step trajectory)
FP8_TRAIN_LOSS_REL = 5e-2
# phase 18, fp8 on the card against the CPU. The same f32 input gives the
# same e4m3 codes on both (checked first, exactly). Through the model the
# activations differ by f32 rounding, and an element that sits on an e4m3
# rounding boundary takes the neighbouring code: one step is 6-12% of
# that element, which moves every output of its row by ~1e-3 and flips
# more codes downstream. The first run (PR 4) measured 3.6% of all
# activation codes differing, gradients within 1.04e-2 of each leaf's
# largest value, prefill logits 2.4e-2 and the loss 8e-4; the bounds are
# about twice those: loss 2e-3 absolute, gradients 3e-2, logits 5e-2
FP8_CHECK_TOL = {"loss": 2e-3, "grad": 3e-2, "logits": 5e-2}
# phase 23, add-LN kernels vs plain, max |Δ| / max |plain| per output: f32
# sums in another order (mu, var, the row means, ds and db over the rows);
# in bf16 one such difference can cross a bf16 rounding of out or dx
# (3.9e-3 of a value)
ADDLN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# BERT-base (paddle_tpu/models/gpt.py:176 bert_base_config) at
# bench.py:bench_bert's seq-512 shape, batch 32
BERT_BASE = {"vocab": 30592, "hidden": 768, "layers": 12, "heads": 12,
             "ffn": 3072, "seq": 512}
BERT_BATCH = 32
# phase 24: the fused encoder's first loss against the composed one's,
# relative. The fused feed-forward takes tanh-form gelu (as the JAX
# package's fused op does) where the composed layer takes the exact erf
# form; the two differ by at most ~4.7e-4 of an activation, and through 12
# post-LN layers that moves a loss of ~10.3 by far less than 1e-3 of it
BERT_FIRST_LOSS_REL = 1e-3
# phase 25, the fused encoder on the card (kernels) against the CPU (plain
# versions), f32: loss relative, each parameter's gradient as max |Δ| /
# max |CPU|. Both run f32 throughout; only summation orders differ (the
# card's flash, fused LN-MLP and add-LN kernels and cuBLAS against the
# CPU's). Three runs measured equal losses and gradients within 1.96e-6
# to 2.06e-6 of each leaf's largest value; the bounds are ~50x that
BERT_CHECK_TOL = {"loss": 1e-5, "grad": 1e-4}


# the warp-specialised Hopper kernels (wgmma + TMA) of phase 2's report:
# source -> the kernel functions' name stems
HOPPER_KERNELS = {"fp8_matmul": ("fp8_mm",),
                  "flash_attention_fwd": ("flash_fwd_wgmma",),
                  "flash_attention_bwd": ("flash_bwd_wgmma",),
                  "fused_ln_mlp": ("gemm_ws",)}


def _template_int(name, stem):
    """The first int template argument of a mangled kernel name after
    ``stem`` (``..stemILi128E..`` -> 128): the head dim or the tile width
    a Hopper kernel was instantiated for."""
    m = re.search(stem + r"ILi(\d+)E", name)
    return int(m.group(1)) if m else None


def _ptxas_props(_build, src, stems):
    """Per kernel function of ``src`` whose name holds one of ``stems``:
    ptxas' registers and its spill stores and spill loads in bytes."""
    entry = None
    props = {}
    for ln in _build.build_log(src).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1) if any(
                st in m.group(1) for st in stems) else None
            if entry:
                props[entry] = {}
        elif entry and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", ln).groups()
            props[entry]["spill_store_bytes"] = int(st)
            props[entry]["spill_load_bytes"] = int(ld)
        elif entry and "Used" in ln and "registers" in ln:
            props[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            props[entry]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return props


def int8_report(_build):
    """The int8 matmul kernels' ptxas registers and spills, and the
    dynamic shared memory a block of the product takes."""
    smem = _build.load("int8_matmul").int8_matmul_smem_bytes()
    return [{"source": "paddle_tpu_torch/csrc/int8_matmul.cu",
             "kernel": name, **p,
             "dynamic_smem_bytes": smem if "int8_mm" in name else 0}
            for name, p in _ptxas_props(_build, "int8_matmul",
                                        ("int8_mm", "int8_quantize")).items()]


def bulk_report(_build):
    """The paged decode (bulk copies) and the MoE gather: per function,
    ptxas' registers, spills and static shared memory, and the dynamic
    shared memory a block takes; and the paged decode clusters the card
    holds at once at phase 4's shape."""
    pa = _build.load("paged_attention")
    rows = []
    for name, p in _ptxas_props(_build, "paged_attention",
                                ("paged_decode",)).items():
        m = re.search(r"paged_decodeI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                      name)
        dyn = pa.paged_attention_smem_bytes(
            int(m.group(2)), int(m.group(3)),
            1 if m.group(1) != "f" else 0) if m else None
        rows.append({"source": "paddle_tpu_torch/csrc/paged_attention.cu",
                     "kernel": name, **p, "dynamic_smem_bytes": dyn})
    for name, p in _ptxas_props(_build, "moe_dispatch",
                                ("moe_gather",)).items():
        rows.append({"source": "paddle_tpu_torch/csrc/moe_dispatch.cu",
                     "kernel": name, **p, "dynamic_smem_bytes": 0})
    return {"bulk_kernels": rows,
            "paged_clusters_resident": pa.paged_attention_resident(
                8, 16, 128, 16, 128, 1)}


def hopper_report(_build):
    """Per Hopper kernel function: ptxas' registers, its spill stores and
    spill loads in bytes (as ptxas gives them), the dynamic shared memory
    a block takes, and, where cuobjdump exists, the wgmma (HGMMA) and TMA
    load (UTMALDG) instructions in its SASS. Raises when such a kernel has
    none of either."""
    smem = {"fp8_matmul": lambda lib, name: lib.fp8_matmul_smem_bytes(),
            "flash_attention_fwd": lambda lib, name: {
                d: lib.flash_attention_fwd_smem_bytes(d) for d in (64, 128)},
            "flash_attention_bwd": lambda lib, name:
                lib.flash_attention_bwd_smem_bytes(
                    _template_int(name, "flash_bwd_wgmma")),
            "fused_ln_mlp": lambda lib, name: lib.fmlp_gemm_smem_bytes(
                _template_int(name, "gemm_ws"))}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        cuobjdump = None
    kernels = []
    for src, stems in HOPPER_KERNELS.items():
        props = _ptxas_props(_build, src, stems)
        sass = {}
        if cuobjdump:
            out = subprocess.run([cuobjdump, "-sass",
                                  str(_build._target(src))],
                                 capture_output=True, text=True,
                                 timeout=120).stdout
            fn = None
            for ln in out.splitlines():
                if "Function :" in ln:
                    fn = ln.split("Function :")[1].strip()
                    sass[fn] = {"HGMMA": 0, "UTMALDG": 0}
                elif fn:
                    for key in sass[fn]:
                        sass[fn][key] += key in ln
        lib = _build.load(src)
        for name, p in props.items():
            row = {"source": f"paddle_tpu_torch/csrc/{src}.cu",
                   "kernel": name, **p,
                   "dynamic_smem_bytes": smem[src](lib, name)}
            if cuobjdump:
                counts = sass.get(name, {})
                row.update({k.lower(): v for k, v in counts.items()})
                if not counts.get("HGMMA") or not counts.get("UTMALDG"):
                    raise AssertionError(f"no wgmma or TMA load in {row}")
            kernels.append(row)
    return {"sass_checked": cuobjdump is not None, "hopper_kernels": kernels}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush=None, budget_ms=200.0, max_reps=100):
    """Mean device time of ``fn`` in ms from CUDA events around each
    call; ``flush`` (outside the timed window) evicts the L2 cache."""
    fn()
    torch.cuda.synchronize()
    reps, spent = 0, 0.0
    times = []
    while reps < 3 or (spent < budget_ms and reps < max_reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        t = start.elapsed_time(end)
        times.append(t)
        spent += t
        reps += 1
    return float(np.mean(times))


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# phase 3: (name, batch, heads, Sq, Sk, head_dim, causal, dtypes)
FLASH_SHAPES = (
    [("gpt_1p3b", 1, 16, sq, sq, 128, True, (torch.bfloat16, torch.float32))
     for sq in (16, 128, 2048)]
    + [("gpt_small", 1, 12, 1024, 1024, 64, True,
        (torch.bfloat16, torch.float32)),
       ("gpt_1p3b_train", 4, 16, 2048, 2048, 128, True, (torch.bfloat16,)),
       ("gpt_small_noncausal", 1, 12, 512, 512, 64, False,
        (torch.bfloat16,)),
       ("ragged", 1, 16, 100, 612, 128, True, (torch.bfloat16,))])


def batch_ms(fn, reps=20):
    """Time per call of ``reps`` calls issued back to back, CUDA events
    around the batch: the host enqueues ahead of the card, so for a call
    that runs longer than its host work this is the device's time alone,
    without the round trip that time_ms's events around a lone call hold
    (torch.profiler lost the cuBLAS kernels of torch._scaled_mm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _attention_pairs(sq, sk, causal):
    """(q, k) pairs the mask leaves, q_pos + (Sk - Sq) >= k_pos."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def flash_phase(dev, fa, stamp, shapes=FLASH_SHAPES):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = {}
    for model, b, h, sq, sk, d, causal, dtypes in shapes:
        for dtype in dtypes:
            q = torch.randn((b, h, sq, d), generator=gen, device=dev) \
                .to(dtype)
            k, v = (torch.randn((b, h, sk, d), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            scale = 1.0 / math.sqrt(d)
            o, lse = fa.flash_attention_forward(q, k, v, causal, scale)
            o_ref, lse_ref = fa._flash_forward_reference(q, k, v, causal,
                                                         scale)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = FLASH_TOL[dtype]
            ok = err_o <= tol_o and err_lse <= tol_lse
            flops = 4 * d * b * h * _attention_pairs(sq, sk, causal)
            nbytes = b * h * (2 * sq * d + 2 * sk * d) * q.element_size() \
                + b * h * sq * 4
            b_ms, b_by = bound(flops, nbytes, dtype)
            call = lambda: fa.flash_attention_forward(  # noqa: E731
                q, k, v, causal, scale)
            lib_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal, scale=scale)
            ms, lib = time_ms(call), time_ms(lib_call)
            b_call, b_lib = batch_ms(call), batch_ms(lib_call)
            row = {
                "phase": "flash_attention", "model": model,
                "shape": [b, h, sq, d], "sk": sk, "causal": causal,
                "dtype": str(dtype)[6:],
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "tol_o": tol_o, "tol_lse": tol_lse, "ok": ok, "ms": ms,
                "plain_ms": time_ms(lambda: fa._flash_forward_reference(
                    q, k, v, causal, scale), max_reps=10),
                "library_ms": lib, "ratio_to_library": ms / lib,
                "batch_ms": b_call, "library_batch_ms": b_lib,
                "batch_ratio_to_library": b_call / b_lib,
                "bound_ms": b_ms, "bound_by": b_by, **stamp}
            emit(row)
            if not ok:
                raise AssertionError(f"flash kernel disagrees: {row}")
            rows[(model, sq, dtype)] = row
            del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return rows


# phase 4: (name, lengths, lanes with a table of their own); the rest
# are stale lanes (all-sink tables with leftover lengths), as unoccupied
# engine slots have. "engine": 8 live slots of ~1040 tokens (the paged
# table width 128 of a 2047-token slot kept)
PAGED_SHAPES = (("ragged", (2047, 1500, 700, 129, 17, 1, 33, 1), 6,
                 (torch.bfloat16, torch.float32)),
                ("engine", (1041, 1039, 1040, 1042, 1038, 1040, 1041, 1037),
                 8, (torch.bfloat16,)))


PAGED_GEOM = (8, 16, 128, 16, 128, 24, 5)   # B, nh, hd, bs, W, L, layer


def l2_flushes(flush_buf):
    """Cache states a kernel is read in: "" after a flush that leaves the
    L2 dirty (``flush_buf`` zeroed), "_warm" no flush, "_clean" after a
    flush that leaves it clean (``flush_buf`` read)."""
    return {"": flush_buf.zero_, "_warm": lambda: None,
            "_clean": lambda: flush_buf.view(torch.int64).max()}


def paged_cases(dev):
    """Phase 4's inputs, one dict a (shape, dtype) of PAGED_SHAPES: q, the
    whole pool (kb, vb), tables, lengths, the bound's operations and
    bytes. The draws come from one seeded generator in a fixed order."""
    B, nh, hd, bs, W, L, layer = PAGED_GEOM
    n_blocks = 1 + B * W
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for shape, lens_, tabled, dtypes in PAGED_SHAPES:
        rng = np.random.default_rng(2)
        lengths = np.asarray(lens_, np.int32)
        tables = np.zeros((B, W), np.int32)
        perm = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
        used = 0
        for b in range(tabled):
            n = -(-int(lengths[b]) // bs)
            tables[b, :n] = perm[used:used + n]
            used += n
        for dtype in dtypes:
            pool = (n_blocks, L, nh, bs, hd)
            kb = torch.randn(pool, generator=gen, device=dev).to(dtype)
            vb = torch.randn(pool, generator=gen, device=dev).to(dtype)
            q = torch.randn((B, nh, hd), generator=gen, device=dev).to(dtype)
            live = int(np.minimum(lengths, W * bs).sum())
            yield {"shape": shape, "dtype": dtype, "q": q, "kb": kb,
                   "vb": vb, "tab": torch.from_numpy(tables).to(dev),
                   "lens": torch.from_numpy(lengths).to(dev),
                   "lengths": lengths, "scale": 1.0 / math.sqrt(hd),
                   "layer": layer,
                   "flops": 4 * live * nh * hd,
                   "nbytes": (2 * live * nh * hd + 2 * B * nh * hd)
                   * q.element_size() + tables.nbytes + lengths.nbytes}
            del kb, vb, q


def paged_times(pa, c, flush_buf):
    """One phase-4 case's times: the lone call (CUDA events, the wrapper's
    host work held, after a dirty flush) and the kernels' own device
    time (torch.profiler) in each of l2_flushes' states, with the
    kernels a call launches."""
    call = lambda: pa.paged_attention_arrays(  # noqa: E731
        c["q"], c["kb"], c["vb"], c["tab"], c["lens"], c["scale"],
        layer=c["layer"])
    row = {"ms": time_ms(call, flush=flush_buf.zero_)}
    for key, fl in l2_flushes(flush_buf).items():
        ms, n, _ = _kernel_device_ms(call, ("paged_decode",), fl,
                                     counts=True)
        row["kernel_ms" + key] = ms
        if key == "":
            row["kernels_per_call"] = n
    return row


def paged_phase(dev, pa, stamp):
    B, nh, hd, bs, W, L, layer = PAGED_GEOM
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for c in paged_cases(dev):
        q, kb, vb, tab, lens, scale = (c[k] for k in (
            "q", "kb", "vb", "tab", "lens", "scale"))
        shape, dtype = c["shape"], c["dtype"]
        before = pa.LAUNCHES
        dense = pa.paged_attention_arrays(q, kb, vb, tab, lens, scale,
                                          ragged=False, layer=layer)
        ragged = pa.paged_attention_arrays(q, kb, vb, tab, lens, scale,
                                           ragged=True, layer=layer)
        wrapper_launches = (pa.LAUNCHES - before) / 2
        ref = pa._paged_attention_reference(q, kb[:, layer], vb[:, layer],
                                            tab, lens, scale)
        zero = pa.paged_attention_arrays(
            q, kb, vb, tab, torch.zeros_like(lens), scale, layer=layer)
        torch.cuda.synchronize()
        err = (dense.float() - ref.float()).abs().max().item()
        identical = bool(torch.equal(dense, ragged))
        zeros = not bool(zero.any())
        b_ms, b_by = bound(c["flops"], c["nbytes"], dtype)
        row = {
            "phase": "paged_attention", "shape": shape, "B": B,
            "nh": nh, "hd": hd, "block_size": bs, "W": W, "layers": L,
            "lengths": c["lengths"].tolist(), "dtype": str(dtype)[6:],
            "cluster": pa.cluster_size(B, nh, W),
            "max_abs_err": err, "tol": PAGED_TOL[dtype],
            "ragged_bit_identical": identical,
            "length0_gives_zeros": zeros,
            "plain_ms": time_ms(lambda: pa._paged_attention_reference(
                q, kb[:, layer], vb[:, layer], tab, lens, scale),
                flush=flush_buf.zero_),
            "bound_ms": b_ms, "bound_by": b_by,
            "wrapper_launches_per_call": wrapper_launches}
        # "ms": a lone call; "kernel_ms": the kernel alone after a dirty
        # flush, "_warm" / "_clean" without one and after a clean one
        row.update(paged_times(pa, c, flush_buf))
        row.update(stamp)
        row["ok"] = ok = (identical and zeros
                          and err <= PAGED_TOL[dtype]
                          and wrapper_launches == 1
                          and row["kernels_per_call"] in (1, None))
        emit(row)
        if not ok:
            raise AssertionError(f"paged kernel disagrees: {row}")
        rows[(shape, dtype)] = row
        del c, kb, vb, q, dense, ragged, ref, zero
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def phase5_requests(V, seed=4):
    """Phase 5's requests in submission order, as (prompt, sampling
    kwargs) pairs: a 64-token sampled prompt, eight greedy prompts of
    profile_decode's LENGTHS (40-1500 tokens), a 300-token sampled
    prompt. Drawn from ``seed`` (phase 5's 4 by default) in phase 5's
    order: the two sampled prompts, then the greedy ones."""
    from paddle_tpu_torch.tools.profile_decode import LENGTHS

    rng = np.random.default_rng(seed)
    sampled = dict(temperature=0.8, top_k=50, top_p=0.95)
    s1 = rng.integers(0, V, 64).astype(np.int32)
    s2 = rng.integers(0, V, 300).astype(np.int32)
    greedy = [rng.integers(0, V, n).astype(np.int32) for n in LENGTHS]
    return [(s1, sampled)] + [(p, {}) for p in greedy] + [(s2, sampled)]


def _greedy(requests):
    return [p for p, kw in requests if not kw]


def engine_phase(dev, cfg, params, paged, fa, pa, stamp, im=None,
                 int8=False, fp_outs=None, md=None, draft=None):
    """The serving phase; with ``int8`` the engine decodes with int8
    weights (``im``: the int8 module, whose launches are counted) and
    ``fp_outs`` (the same mode's bf16 streams) gives the share of greedy
    tokens that the int8 run repeats. ``md`` (the MoE dispatch module)
    counts the gather kernel's launches of a MoE config's run and reads
    the router gauges. ``draft`` (a ``(cfg, params)`` pair) serves with
    speculative decoding, SPEC_K proposals a tick, and reports the
    acceptance of the batched run."""
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    V = cfg.vocab_size
    requests = phase5_requests(V)
    s1, sampled = requests[0]
    new = 32

    spec = {} if draft is None else {"draft": draft, "spec_k": SPEC_K}
    torch.cuda.reset_peak_memory_stats(dev)
    ms0 = {k: stat_get(k) for k in ("serving_prefill_ms",
                                    "serving_decode_ms",
                                    "moe_tokens_dropped", "spec_proposed",
                                    "spec_accepted")}
    eng = InferenceEngine(cfg, params, n_slots=8, seed=5, paged=paged,
                          int8_weights=int8, **spec)
    fa.LAUNCHES = 0
    pa.LAUNCHES = 0
    if im is not None:
        im.LAUNCHES = 0
    if md is not None:
        md.LAUNCHES = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=new, **kw) for p, kw in requests]
    outs = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.LAUNCHES,
                "paged_attention_decode": pa.LAUNCHES}
    if im is not None:
        launches["int8_matmul"] = im.LAUNCHES
    if md is not None:
        launches["moe_dispatch_gather"] = md.LAUNCHES
    moe_load = stat_get("moe_expert_load")
    proposed = stat_get("spec_proposed") - ms0["spec_proposed"]
    accepted = stat_get("spec_accepted") - ms0["spec_accepted"]
    eng.shutdown()
    prefill_ms = stat_get("serving_prefill_ms") - ms0["serving_prefill_ms"]
    decode_ms = stat_get("serving_decode_ms") - ms0["serving_decode_ms"]
    peak = torch.cuda.max_memory_allocated(dev)
    for r, out in zip(reqs, outs):
        if len(out) != new or r.finish_reason != "length" \
                or not all(0 <= t < V for t in out):
            raise AssertionError(f"request {r.rid} finished badly: "
                                 f"{r.finish_reason} {out}")
    # a speculative paged run attends in composed PyTorch on every tick
    # (the verify's multi-query shape, as in JAX) and prefills in composed
    # chunks: it launches the paged kernel only on one-token fallback
    # ticks, which this run's headroom never forces
    want = None if draft is not None and paged else \
        "paged_attention_decode" if paged else "flash_attention_fwd"
    if int8 and launches.get("int8_matmul", 0) <= 0:
        raise AssertionError("int8_matmul never launched in the int8 "
                             "engine run")
    if want is not None and launches[want] <= 0:
        raise AssertionError(f"{want} never launched in the "
                             f"{'paged' if paged else 'fixed'} engine run")
    if md is not None and launches["moe_dispatch_gather"] <= 0:
        raise AssertionError("moe_dispatch_gather never launched in the "
                             "MoE engine run")

    # replay the first sampled request alone on a fresh engine (same
    # seed, same request id): the stream must repeat exactly; then time
    # one 1500-token prompt's prefill on that warm engine
    eng = InferenceEngine(cfg, params, n_slots=8, seed=5, paged=paged,
                          int8_weights=int8, **spec)
    replay = eng.generate(s1, max_new_tokens=new, **sampled)
    t1 = time.perf_counter()
    eng.generate(requests[-2][0], max_new_tokens=1)     # 1500 tokens
    ttft_1500 = (time.perf_counter() - t1) * 1e3
    eng.shutdown()
    want = outs[0]
    if int8:
        # the activations' int8 scale is one abs-max over every slot of a
        # tick (per tensor, as in JAX), so an int8 stream depends on the
        # batch it decoded in, and the batch depends on when requests were
        # admitted: a lone replay is held against a second lone replay
        eng = InferenceEngine(cfg, params, n_slots=8, seed=5, paged=paged,
                              int8_weights=int8)
        want = eng.generate(s1, max_new_tokens=new, **sampled)
        eng.shutdown()
    if replay != want:
        raise AssertionError(f"sampled replay differs: {replay} vs {want}")
    decode_tokens = sum(len(o) for o in outs) - len(outs)
    greedy_equal = None
    if fp_outs is not None:
        pairs = [(a, b) for o, f in zip(outs[1:-1], fp_outs[1:-1])
                 for a, b in zip(o, f)]
        greedy_equal = sum(a == b for a, b in pairs) / len(pairs)
    if draft is not None and not 0 < accepted <= proposed:
        raise AssertionError(f"speculative run proposed {proposed}, "
                             f"accepted {accepted}")
    row = {"phase": ("engine_int8" if int8 else
                     "engine_moe" if md is not None else
                     "engine_spec" if draft is not None else "engine"),
           "mode": "paged" if paged else "fixed",
           "model": "gpt_1p3b", "layers": cfg.n_layers,
           "hidden": cfg.hidden, "moe_experts": cfg.moe_experts,
           "moe_top_k": cfg.moe_top_k if cfg.moe_experts else None,
           "params": sum(t.numel() for t in _leaves(params)),
           "requests": len(reqs),
           "new_tokens": new, "launches": launches, "wall_s": wall,
           "prefill_ms_total": prefill_ms, "decode_ms_total": decode_ms,
           "decode_tokens": decode_tokens,
           "decode_tok_s": decode_tokens / max(decode_ms, 1) * 1e3,
           "prefill_1500_ms": ttft_1500, "peak_mem_gib": peak / 2**30,
           "sampled_replay_identical": True,
           "sampled_replay_of": "a second lone run" if int8
           else "the batched run",
           "greedy_tokens_equal_to_bf16_share": greedy_equal, **stamp}
    if draft is not None:
        row.update(spec_k=SPEC_K, draft_layers=draft[0].n_layers,
                   spec_proposed=proposed, spec_accepted=accepted,
                   spec_acceptance_rate=accepted / proposed)
    if md is not None:
        row["moe_expert_load_ppm"] = moe_load
        row["moe_tokens_dropped"] = (stat_get("moe_tokens_dropped")
                                     - ms0["moe_tokens_dropped"])
        if not 0 < moe_load <= 1e6 or row["moe_tokens_dropped"] != 0:
            raise AssertionError(f"MoE router gauges are off: {row}")
    emit(row)
    row["outs"] = outs
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def logits_phase(dev, params, stamp):
    """Paged decode (kernel) vs fixed decode (composed) on one state."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving import KVCache, PagedKVCache, cache_insert

    cfg = G.gpt_1p3b(dtype=torch.float32)
    rng = np.random.default_rng(6)
    lens = [1000, 333, 47]
    bs = 16
    fixed = KVCache(cfg, n_slots=3, device=dev)
    paged = PagedKVCache(cfg, n_slots=3, n_blocks=1 + 3 * 128,
                         block_size=bs, device=dev)
    with torch.inference_mode():
        for slot, n in enumerate(lens):
            toks = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (1, n))).to(dev)
            _, (ke, ve) = G.gpt_prefill(cfg, params, toks)
            cache_insert(fixed.k, fixed.v, slot, ke[0], ve[0])
            assert paged.alloc() == slot and paged.grow(slot, n + 1)
            for j, blk in enumerate(paged.block_tables[slot]):
                m = min(bs, n - bs * j)
                if m > 0:
                    paged.kb[blk, :, :, :m] = ke[0, :, :, bs * j:bs * j + m]
                    paged.vb[blk, :, :, :m] = ve[0, :, :, bs * j:bs * j + m]
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        tok = torch.tensor([11, 22, 33], dtype=torch.int32, device=dev)
        want, _ = G.gpt_decode_step(cfg, params, (fixed.k, fixed.v), pos, tok)
        tables = paged.tables_array()
        tables = tables[:, :max(len(t) for t in paged.block_tables)]
        got, _ = G.gpt_decode_step_paged(
            cfg, params, (paged.kb, paged.vb),
            torch.from_numpy(np.ascontiguousarray(tables)).to(dev), pos, tok)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= LOGITS_TOL \
        and got.shape == (3, cfg.vocab_size)
    row = {"phase": "decode_logits", "model": "gpt_1p3b", "dtype": "float32",
           "lengths": lens, "max_abs_err": err, "tol": LOGITS_TOL,
           "max_abs_logit": want.abs().max().item(), "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"paged and fixed decode disagree: {row}")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def flash_bwd_phase(dev, fa, stamp):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = {}
    shapes = [("gpt_1p3b_train", 4, 16, 2048, 128),
              ("ragged", 1, 16, 100, 128), ("gpt_small", 1, 12, 1024, 64)]
    for dtype in (torch.bfloat16, torch.float32):
        for model, b, h, s, d in shapes:
            q, k, v, do = (torch.randn((b, h, s, d), generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(4))
            scale = 1.0 / math.sqrt(d)
            o, lse = fa._launch(q, k, v, True, scale)
            got = fa._flash_backward(q, k, v, o, lse, do, True, scale)
            want = fa._flash_backward_reference(q, k, v, o, lse, do, True,
                                                scale)
            torch.cuda.synchronize()
            errs = {n: (g.float() - w.float()).abs().max().item()
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            rel = max(_rel(g, w) for g, w in zip(got, want))
            ok = rel <= GRAD_TOL[dtype] and all(
                bool(torch.isfinite(g).all()) for g in got)
            del got, want
            pairs = b * h * s * (s + 1) // 2   # causal (q, k) pairs
            flops = 10 * d * pairs             # s, dp, dV, dK, dQ
            es = q.element_size()
            # read q, k, v, o, dO, lse; write dq, dk, dv
            nbytes = b * h * (8 * s * d * es + s * 4)
            b_ms, b_by = bound(flops, nbytes, dtype)
            qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  scale=scale)
            call = lambda: fa._flash_backward(  # noqa: E731
                q, k, v, o, lse, do, True, scale)
            lib_call = lambda: torch.autograd.grad(  # noqa: E731
                sdpa, (qs, ks, vs), do, retain_graph=True)
            ms, lib = time_ms(call), time_ms(lib_call)
            b_call, b_lib = batch_ms(call), batch_ms(lib_call)
            row = {
                "phase": "flash_attention_bwd", "model": model,
                "shape": [b, h, s, d], "dtype": str(dtype)[6:],
                "kernel": fa.kernel_for(dtype, d),
                "max_abs_err": errs, "max_rel_err": rel,
                "tol_rel": GRAD_TOL[dtype], "ok": ok, "ms": ms,
                "plain_ms": time_ms(lambda: fa._flash_backward_reference(
                    q, k, v, o, lse, do, True, scale), max_reps=10),
                "library_ms": lib, "ratio_to_library": ms / lib,
                "batch_ms": b_call, "library_batch_ms": b_lib,
                "batch_ratio_to_library": b_call / b_lib,
                "library": "scaled_dot_product_attention backward",
                "bound_ms": b_ms, "bound_by": b_by, **stamp}
            emit(row)
            if not ok:
                raise AssertionError(f"flash backward disagrees: {row}")
            rows[(model, dtype)] = row
            del q, k, v, do, o, lse, qs, ks, vs, sdpa
            torch.cuda.empty_cache()
    return rows


def fmlp_phase(dev, fk, stamp):
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows = {}
    H, M = 2048, 8192
    for dtype in (torch.bfloat16, torch.float32):
        for R in (8192, 100):
            def n(*sh, sc=1.0):
                return torch.randn(sh, generator=gen, device=dev) * sc

            x, dy = n(R, H).to(dtype), n(R, H).to(dtype)
            w1, w2 = n(H, M, sc=0.02).to(dtype), n(M, H, sc=0.02).to(dtype)
            b1, b2 = n(M, sc=0.02).to(dtype), n(H, sc=0.02).to(dtype)
            lns, lnb = 1.0 + n(H, sc=0.1), n(H, sc=0.1)
            fargs = (x, lns, lnb, w1, b1, w2, b2, None, None, "gelu", True,
                     True, 1e-5)
            y, mu, rstd = fk._fmlp_forward(*fargs)
            y_ref, mu_ref, rstd_ref = fk._fmlp_forward_reference(*fargs)
            bargs = (x, lns, lnb, w1, b1, w2, None, None, mu_ref, rstd_ref,
                     dy, "gelu", True, True)
            got = fk._fmlp_backward(*bargs)
            want = fk._fmlp_backward_reference(*bargs)
            # the dW2 kernel alone, on the activation the backward uses
            lnx = fk._lnx(x, lns, lnb, mu_ref, rstd_ref)
            a = fk._act(fk._mm32(lnx, w1) + b1.float(), "gelu").to(dtype)
            dw2 = fk._launch_dw2(a, dy)
            dw2_ref = fk._mm32(a.t(), dy)
            torch.cuda.synchronize()
            names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
            rel_f = _rel(y, y_ref)
            rel_b = {nm: _rel(g, w) for nm, g, w in zip(names, got, want)}
            rel_dw2 = _rel(dw2, dw2_ref)
            dabs = lambda g, w: (g.float() - w.float()).abs().max().item()
            abs_f, abs_dw2 = dabs(y, y_ref), dabs(dw2, dw2_ref)
            abs_b = {nm: dabs(g, w) for nm, g, w in zip(names, got, want)}
            ok = max([rel_f, rel_dw2, *rel_b.values()]) <= FMLP_TOL[dtype]
            del got, want, y_ref, dw2, dw2_ref
            rhm = R * H * M
            es = x.element_size()
            # forward: read x, W1, b1, W2, b2, LN params; write y, mu, rstd
            f_bytes = (2 * R * H + 2 * H * M + M + H) * es \
                + 4 * (2 * H + 2 * R)
            # backward: read x, dy, W1, b1, W2, LN params, mu, rstd; write
            # dx, dW1, dW2 (f32), db1, db2, dscale, dbias
            b_bytes = (2 * R * H + 2 * H * M + M) * es \
                + 4 * (2 * H + 2 * R) + 4 * (R * H + 2 * H * M + M + 3 * H)
            fb_ms, fb_by = bound(4 * rhm, f_bytes, dtype)
            bb_ms, bb_by = bound(8 * rhm, b_bytes, dtype)
            db_ms, db_by = bound(2 * rhm, (R * M + R * H) * es + 4 * M * H,
                                 dtype)
            # yardstick: the same MLP as composed PyTorch ops (cuBLAS
            # matmuls), forward and autograd backward
            xs = x.detach().requires_grad_(True)
            ws = [t.detach().requires_grad_(True)
                  for t in (w1, b1, w2, b2, lns, lnb)]

            def composed():
                return fk._ln_mlp_reference(xs, ws[4], ws[5], ws[0], ws[1],
                                            ws[2], ws[3], None, None, "gelu",
                                            True, True, 1e-5)

            y_c = composed()
            row = {
                "phase": "fused_ln_mlp", "act": "gelu", "R": R, "H": H,
                "M": M, "dtype": str(dtype)[6:],
                "max_abs_err_y": abs_f, "max_abs_err_grads": abs_b,
                "max_abs_err_dw2": abs_dw2,
                "max_rel_err_y": rel_f, "max_rel_err_grads": rel_b,
                "max_rel_err_dw2": rel_dw2, "tol_rel": FMLP_TOL[dtype],
                "ok": ok,
                "fwd_ms": time_ms(lambda: fk._fmlp_forward(*fargs)),
                "fwd_plain_ms": time_ms(
                    lambda: fk._fmlp_forward_reference(*fargs), max_reps=10),
                "fwd_bound_ms": fb_ms, "fwd_bound_by": fb_by,
                "bwd_ms": time_ms(lambda: fk._fmlp_backward(*bargs)),
                "bwd_plain_ms": time_ms(
                    lambda: fk._fmlp_backward_reference(*bargs),
                    max_reps=10),
                "bwd_bound_ms": bb_ms, "bwd_bound_by": bb_by,
                "dw2_ms": time_ms(lambda: fk._launch_dw2(a, dy)),
                "dw2_plain_ms": time_ms(lambda: fk._mm32(a.t(), dy)),
                "dw2_bound_ms": db_ms, "dw2_bound_by": db_by,
                "composed_cublas_fwd_ms": time_ms(composed),
                "composed_cublas_bwd_ms": time_ms(
                    lambda: torch.autograd.grad(y_c, [xs] + ws, dy,
                                                retain_graph=True)),
                "fwd_kernel": fk.mlp_fwd_kernel_for(dtype),
                "fwd_kernels_ms": _fmlp_breakdown(
                    lambda: fk._fmlp_forward(*fargs), FMLP_FWD_KERNELS),
                "bwd_kernel": fk.mlp_bwd_kernel_for(dtype),
                "bwd_kernels_ms": _fmlp_breakdown(
                    lambda: fk._fmlp_backward(*bargs), FMLP_BWD_KERNELS),
                **stamp}
            row["fwd_ratio_to_composed"] = \
                row["fwd_ms"] / row["composed_cublas_fwd_ms"]
            if dtype == torch.bfloat16:
                # the Hopper forward's other epilogues: relu, and swiglu's
                # two products into two accumulators
                row["fwd_other_acts"] = {
                    act: _fmlp_fwd_check(fk, x, lns, lnb, w1, b1, w2, b2,
                                         act, n(H, M, sc=0.02).to(dtype),
                                         n(M, sc=0.02).to(dtype))
                    for act in ("relu", "swiglu")}
                ok = ok and all(v["ok"]
                                for v in row["fwd_other_acts"].values())
                row["ok"] = ok
            emit(row)
            if not ok:
                raise AssertionError(f"fused LN-MLP disagrees: {row}")
            rows[(R, dtype)] = row
            del x, dy, w1, w2, a, y_c, xs, ws, lnx
            torch.cuda.empty_cache()
    return rows


def _fmlp_fwd_check(fk, x, lns, lnb, w1, b1, w2, b2, act, wg, bg):
    """The fused LN-MLP forward for ``act`` (wg/bg swiglu's gate) against
    its plain version: errors, the lone call's and each kernel's time."""
    gate = act == "swiglu"
    fargs = (x, lns, lnb, w1, b1, w2, b2, wg if gate else None,
             bg if gate else None, act, True, True, 1e-5)
    y = fk._fmlp_forward(*fargs)[0]
    y_ref = fk._fmlp_forward_reference(*fargs)[0]
    torch.cuda.synchronize()
    rel = _rel(y, y_ref)
    return {"max_abs_err_y": (y.float() - y_ref.float()).abs().max().item(),
            "max_rel_err_y": rel, "ok": rel <= FMLP_TOL[x.dtype],
            "fwd_ms": time_ms(lambda: fk._fmlp_forward(*fargs)),
            "fwd_kernels_ms": _fmlp_breakdown(
                lambda: fk._fmlp_forward(*fargs), FMLP_FWD_KERNELS)}


# phase 8: a forward or backward kernel's label from its (demangled)
# name, the first match in this order
FMLP_FWD_KERNELS = (("(1) ln_rows", ("ln_rows",)),
                    ("(2) lnx·W1 -> a", ("EpiUp", "fmlp_up")),
                    ("(3) a·W2 -> y", ("EpiDown", "fmlp_down")))
FMLP_BWD_KERNELS = (("(1') ln_rows", ("ln_rows",)),
                    ("(4) da, z -> dz, a, db1", ("EpiActBwd", "fmlp_act_bwd")),
                    ("(5) dW1 + (7) dW2", ("Prod<1,1,0>", "fmlp_wgrad")),
                    ("(6) dlnx", ("EpiStoreF32", "fmlp_dx")))


def _pytorch_kernel_label(key):
    """A PyTorch kernel's name, shortened: its namespaces and argument
    list dropped, at most 100 characters."""
    key = re.sub(r"^void |at::native::|\(anonymous namespace\)::|"
                 r"c10::|std::", "", key)
    depth = 0
    for i, ch in enumerate(key):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            key = key[:i]
            break
    return key.strip()[:100]


def _fmlp_breakdown(fn, kernels, reps=3):
    """Device ms per call of each kernel of the fused LN-MLP forward or
    backward (``FMLP_FWD_KERNELS`` / ``FMLP_BWD_KERNELS``; the
    backward's (5) and (7) are one kernel, two launches a call) and of
    the PyTorch work around them (the backward's LN backward, db2, the
    residual add and the zeroing of db1): ``pytorch`` their sum,
    ``pytorch_kernels`` each PyTorch kernel by its name. From one
    torch.profiler pass over ``reps`` calls; None when the trace has no
    device time."""
    from paddle_tpu_torch.tools.profile_decode import _device_us

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label, _ in kernels}
    out["pytorch"] = 0.0
    each = {}
    seen = False
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        if us <= 0:
            continue
        seen = True
        key = e.key.replace(" ", "")
        label = next((lb for lb, stems in kernels
                      if any(st in key for st in stems)), "pytorch")
        out[label] += us / reps / 1e3
        if label == "pytorch":
            name = _pytorch_kernel_label(e.key)
            each[name] = each.get(name, 0.0) + us / reps / 1e3
    out["pytorch_kernels"] = dict(sorted(each.items(), key=lambda kv: -kv[1]))
    return out if seen else None


def _training_counts(fa, fk):
    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "fused_ln_mlp_fwd": fk.FWD_LAUNCHES,
            "fused_ln_mlp_bwd": fk.BWD_LAUNCHES,
            "fused_ln_mlp_bwd_dw2": fk.DW2_LAUNCHES}


def _reset_training_counts(fa, fk):
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    fk.FWD_LAUNCHES = fk.BWD_LAUNCHES = fk.DW2_LAUNCHES = 0


def train_phase(dev, fa, fk, stamp, steps=6, fo=None, ref=None, cfg=None,
                extra=None, phase=None, ref_tol=TRAIN_LOSS_REL,
                first_equal=True):
    """Phase 9; with ``fo`` (the fused-optimizer module) phase 12's AdamW
    run: the same configuration with FLAGS_fused_optimizer=1, its losses
    held against ``ref`` (phase 9's row). ``cfg`` replaces phase 9's
    config (phases 17 and 22), ``extra`` names more kernel modules whose
    launches must rise, ``ref_tol`` bounds each loss's distance to
    ``ref``'s, relative, and ``first_equal`` asks the first losses to be
    equal."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import DistributedTrainStep
    from paddle_tpu_torch.parallel import train_step as TS

    cfg = cfg or G.gpt_1p3b(remat=True, fused_mlp=True)
    extra = extra or {}
    B, S, chunk = 4, cfg.seq_len, 256
    rng = np.random.default_rng(9)
    batch = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))))
    norms = []

    def update(params, grads, state, lr, **kw):
        sq = sum(torch.sum(torch.square(g.float()))
                 for _, g in TS._paths(grads))
        norms.append(torch.sqrt(sq))
        return TS.pure_adamw_update(params, grads, state, lr, **kw)

    old = flags.fused_optimizer[0]
    flags.fused_optimizer[0] = fo is not None
    try:
        step = DistributedTrainStep(
            lambda p, b: G.gpt_loss(cfg, p, b, loss_chunk=chunk),
            G.gpt_init(cfg, seed=0, device=dev),
            optimizer="adamw" if fo is not None
            else (TS.pure_adamw_init, update), lr=1e-4, device=dev)
    finally:
        flags.fused_optimizer[0] = old
    if fo is not None and step._update_fn is not fo.fused_adamw_update:
        raise AssertionError("FLAGS_fused_optimizer=1 did not select the "
                             "fused AdamW update")
    n_params = sum(t.numel() for _, t in TS._paths(step.params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    _reset_training_counts(fa, fk)
    if fo is not None:
        fo.ADAMW_LAUNCHES = 0
    for mod in extra.values():
        mod.LAUNCHES = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(step(batch))     # the host read syncs the step
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = _training_counts(fa, fk)
    if fo is not None:
        launches["fused_adamw"] = fo.ADAMW_LAUNCHES
    launches.update({name: mod.LAUNCHES for name, mod in extra.items()})
    peak = torch.cuda.max_memory_allocated(dev)
    gnorms = [float(x) for x in norms]
    step_ms = float(np.median(times[-3:]))
    tokens = B * S
    # the fused LN-MLP runs where a dense layer does not take the fp8 MLP
    fused = cfg.fused_mlp and not cfg.fp8 \
        and len(cfg.moe_layer_ids) < cfg.n_layers
    required = [k for k in launches if fused or not k.startswith("fused_ln")]
    ok = all(math.isfinite(x) for x in losses + gnorms) \
        and losses[-1] < losses[0] and all(launches[k] > 0 for k in required)
    row = {"phase": phase or ("train_fused_adamw" if fo is not None
                              else "train"),
           "model": "gpt_1p3b", "layers": cfg.n_layers,
           "hidden": cfg.hidden, "remat": cfg.remat,
           "fused_mlp": cfg.fused_mlp, "fp8": bool(cfg.fp8),
           "moe_experts": cfg.moe_experts,
           "optimizer": "adamw", "fused_optimizer": fo is not None,
           "lr": 1e-4, "batch": [B, S],
           "loss_chunk": chunk, "params": n_params, "steps": steps,
           "losses": losses, "grad_norms": gnorms, "step_ms": times,
           "step_ms_median_last3": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           # 6·N·T counts every parameter once per token: not a MoE's
           "model_flops_share": None if cfg.moe_experts else 6.0 * n_params
           * tokens / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "peak_mem_gib": peak / 2**30, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    if ref is not None:
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        row.update({"ref_losses": ref["losses"], "loss_rel_err": rel,
                    "tol_rel": ref_tol,
                    "first_loss_equal": losses[0] == ref["losses"][0]})
        ok = ok and max(rel) <= ref_tol \
            and (losses[0] == ref["losses"][0] or not first_equal)
    row.update({"ok": ok, **stamp})
    emit(row)
    if not ok:
        raise AssertionError(f"training phase failed: {row}")
    del step
    torch.cuda.empty_cache()
    return row


def grads_phase(dev, stamp):
    """One step's loss and grads, kernels on the card vs plain on the CPU."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import train_step as TS

    cfg = G.gpt_1p3b(n_layers=2, dtype=torch.float32, fused_mlp=True,
                     remat=True)
    params = G.gpt_init(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(10)
    batch = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))))

    def run(device):
        p = {k: ({kk: vv.to(device).requires_grad_(True)
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(device).requires_grad_(True))
             for k, v in params.items()}
        loss = G.gpt_loss(cfg, p, batch, loss_chunk=128)
        loss.backward()
        return float(loss.detach()), {path: t.grad.cpu()
                                      for path, t in TS._paths(p)}

    t0 = time.perf_counter()
    l_card, g_card = run(dev)
    t1 = time.perf_counter()
    l_cpu, g_cpu = run("cpu")
    t2 = time.perf_counter()
    rel = {"/".join(path): _rel(g_card[path], g)
           for path, g in g_cpu.items()}
    tol = {k: TRAIN_GRAD_TOL["wte" if k == "wte" else "other"] for k in rel}
    ok = abs(l_card - l_cpu) <= 1e-4 and all(rel[k] <= tol[k] for k in rel)
    row = {"phase": "train_grads", "model": "gpt_1p3b", "layers": 2,
           "dtype": "float32", "batch": [1, 256], "loss_card": l_card,
           "loss_cpu": l_cpu, "max_rel_err": rel, "tol_rel": tol,
           "card_s": t1 - t0, "cpu_s": t2 - t1, "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"card and CPU gradients disagree: {row}")
    return row


def _opt_bytes(ps, gs, ms, lamb):
    """Bytes the update must move: read p, g, m, v; write p, m, v
    (AdamW) or m, v and an f32 r (LAMB)."""
    total = 0
    for p, g, m in zip(ps, gs, ms):
        n = p.numel()
        reads = n * (p.element_size() + g.element_size()
                     + 2 * m.element_size())
        writes = n * (2 * m.element_size()
                      + (4 if lamb else p.element_size()))
        total += reads + writes
    return total


def _opt_bucket(name, ps, mdt, gen):
    gs = [torch.randn(p.shape, generator=gen, device=p.device) * 0.01
          for p in ps]
    ms = [(torch.randn(p.shape, generator=gen, device=p.device) * 1e-3)
          .to(mdt) for p in ps]
    vs = [(torch.rand(p.shape, generator=gen, device=p.device) * 1e-5)
          .to(mdt) for p in ps]
    return name, ps, gs, ms, vs


def opt_phase(dev, fo, stamp):
    """Phase 11: the fused AdamW and LAMB kernels against their plain
    versions on whole-model and ragged buckets."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import train_step as TS

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    full = [t for _, t in TS._paths(G.gpt_init(G.gpt_1p3b(), seed=0,
                                               device=dev))]
    ragged = [torch.randn(n, generator=gen, device=dev)
              for n in (1, 3, 1000, 4099, 20000)]
    ragged.append(torch.randn(1001, generator=gen, device=dev)[1:])
    sc = torch.tensor([1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    akw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01, l2=0.0,
               eager_form=False)
    lkw = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)
    rows = {}
    for bucket in ("gpt_1p3b_f32", "gpt_1p3b_bf16_moments", "ragged_f32",
                   "ragged_bf16_moments"):
        leaves = full if bucket.startswith("gpt") else ragged
        mdt = torch.bfloat16 if "bf16" in bucket else torch.float32
        name, ps, gs, ms, vs = _opt_bucket(bucket, leaves, mdt, gen)
        n = sum(p.numel() for p in ps)
        # AdamW: the kernel on copies, in place; the plain version leaf by
        # leaf from the originals
        cp = [t.clone() for t in ps]
        cm = [t.clone() for t in ms]
        cv = [t.clone() for t in vs]
        fo._bucket_adamw(cp, gs, cm, cv, sc, **akw)
        torch.cuda.synchronize()
        err, identical = 0.0, True
        for i in range(len(ps)):
            want = fo._adamw_flat_reference(ps[i], gs[i], ms[i], vs[i],
                                            sc[0], sc[1], sc[2], **akw)
            for got, w in zip((cp[i], cm[i], cv[i]), want):
                identical &= bool(torch.equal(got, w))
                err = max(err, (got.float() - w.float()).abs().max().item())
            del want
        a_ms = time_ms(lambda: fo._bucket_adamw(cp, gs, cm, cv, sc, **akw))
        def adamw_plain():
            for p, g, m, v in zip(ps, gs, ms, vs):
                fo._adamw_flat_reference(p, g, m, v, sc[0], sc[1], sc[2],
                                         **akw)

        a_plain = time_ms(adamw_plain, max_reps=3)
        steps = [torch.full((), 3.0, device=dev) for _ in ps]
        lib = None
        if mdt == torch.float32:
            lib = time_ms(lambda: torch._fused_adamw_(
                cp, gs, cm, cv, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
                weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False))
        del cp, cm, cv
        torch.cuda.empty_cache()
        ab_ms, ab_by = bound(15 * n, _opt_bytes(ps, gs, ms, False),
                             torch.float32)
        # LAMB: groups of leaves share one r buffer; each group's r is
        # held against the plain version before the next group reuses it
        cm = [t.clone() for t in ms]
        cv = [t.clone() for t in vs]
        l_err, l_identical, groups = 0.0, True, 0
        for idx, rs in fo._bucket_lamb(ps, gs, cm, cv, sc, **lkw):
            groups += 1
            for j, r in zip(idx, rs):
                want = fo._lamb_flat_reference(ps[j], gs[j], ms[j], vs[j],
                                               sc[1], sc[2], **lkw)
                for got, w in zip((cm[j], cv[j], r), want):
                    l_identical &= bool(torch.equal(got, w))
                    l_err = max(l_err,
                                (got.float() - w.float()).abs().max().item())
                del want
        l_ms = time_ms(lambda: list(fo._bucket_lamb(ps, gs, cm, cv, sc,
                                                    **lkw)))
        def lamb_plain():
            for p, g, m, v in zip(ps, gs, ms, vs):
                fo._lamb_flat_reference(p, g, m, v, sc[1], sc[2], **lkw)

        l_plain = time_ms(lamb_plain, max_reps=3)
        lb_ms, lb_by = bound(12 * n, _opt_bytes(ps, gs, ms, True),
                             torch.float32)
        del cm, cv
        ok = identical and l_identical
        row = {"phase": "fused_optimizer", "bucket": name, "leaves": len(ps),
               "params": n, "moments": str(mdt)[6:],
               "adamw_bit_identical": identical, "adamw_max_abs_err": err,
               "adamw_ms": a_ms, "adamw_plain_ms": a_plain,
               "adamw_library_ms": lib,
               "library": "torch._fused_adamw_" if lib is not None else None,
               "adamw_bound_ms": ab_ms, "adamw_bound_by": ab_by,
               "lamb_bit_identical": l_identical, "lamb_max_abs_err": l_err,
               "lamb_launches_per_call": groups,
               "lamb_ms": l_ms, "lamb_plain_ms": l_plain,
               "lamb_bound_ms": lb_ms, "lamb_bound_by": lb_by,
               "ok": ok, **stamp}
        emit(row)
        if not ok:
            raise AssertionError(f"fused optimizer kernels disagree: {row}")
        rows[name] = row
        del ps, gs, ms, vs
        torch.cuda.empty_cache()
    del full, ragged
    torch.cuda.empty_cache()
    return rows


def lamb_train_phase(dev, fo, stamp, steps=3):
    """Phase 12 (LAMB): fused against pure at full width, 2 layers, both
    fed the gradients of the fused trajectory, so that the params differ
    only by the optimizers."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import train_step as TS

    cfg = G.gpt_1p3b(n_layers=2, remat=True, fused_mlp=True)
    rng = np.random.default_rng(12)
    batch = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2048))),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2048))))
    fused = G.gpt_init(cfg, seed=4, device=dev)
    pure = TS._map(lambda t: t.clone(), fused)
    leaves = [t.requires_grad_(True) for _, t in TS._paths(fused)]
    s_f, s_p = TS.pure_lamb_init(fused), TS.pure_lamb_init(pure)
    fo.LAMB_LAUNCHES = 0
    losses, rel = [], {}
    for _ in range(steps):
        loss = G.gpt_loss(cfg, fused, batch, loss_chunk=256)
        grads = torch.autograd.grad(loss, leaves)
        gtree = TS._map(lambda t: t, fused)
        for (path, _), g in zip(TS._paths(fused), grads):
            TS._put(gtree, path, g)
        losses.append(float(loss.detach()))
        fo.fused_lamb_update(fused, gtree, s_f, 1e-3)
        TS.pure_lamb_update(pure, gtree, s_p, 1e-3)
        del grads, gtree
        for path, t in TS._paths(pure):
            key = "/".join(path)
            rel[key] = max(rel.get(key, 0.0),
                           _rel(TS._get(fused, path).detach(), t))
    launches = fo.LAMB_LAUNCHES
    ok = all(math.isfinite(x) for x in losses) and launches > 0 \
        and max(rel.values()) <= LAMB_PARAM_TOL
    row = {"phase": "train_fused_lamb", "model": "gpt_1p3b", "layers": 2,
           "batch": [2, 2048], "steps": steps, "losses": losses,
           "max_rel_err_per_leaf": rel, "tol_rel": LAMB_PARAM_TOL,
           "launches": {"fused_lamb": launches}, "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"fused and pure LAMB disagree: {row}")
    del fused, pure, leaves, s_f, s_p
    torch.cuda.empty_cache()
    return row


# phase 13: (M, K, N, bias, per-row scales, out dtype) beyond the decode
# shapes; K = 33000 takes a block of its clusters past one 4096-deep pass
INT8_EXTRA_SHAPES = ((100, 64, 192, True, False, torch.bfloat16),
                     (3, 50, 37, True, True, torch.bfloat16),
                     (9, 130, 20, False, True, torch.float32),
                     (2, 33000, 48, True, False, torch.float32))


def int8_phase(dev, im, stamp):
    """Phase 13: the int8 matmul kernel against its plain version, both
    entries."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    shapes = [(m, k, n, False, False, torch.bfloat16) for m in (8, 1)
              for k, n in ((2048, 6144), (2048, 2048), (2048, 8192),
                           (8192, 2048))] + list(INT8_EXTRA_SHAPES)
    rows = {}

    def launches(fn):
        """Kernel launches of one call of fn."""
        before = im.LAUNCHES
        fn()
        return im.LAUNCHES - before

    for M, K, N, with_bias, per_row, out in shapes:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(N, generator=gen, device=dev) * 1e-3 + 1e-5
        xs = torch.rand((M, 1) if per_row else (), generator=gen,
                        device=dev) * 0.05 + 1e-3
        b = torch.randn(N, generator=gen, device=dev) if with_bias else None
        # the fused entry's activations, in the decode path's bf16
        xf = torch.randn((M, K), generator=gen, device=dev).to(
            torch.bfloat16)

        def call():
            return im.int8_matmul_arrays(xq, wq, ws, xs, bias=b,
                                         out_dtype=out)

        def dyn():
            return im.dynamic_int8_matmul(xf, wq, ws, bias=b)

        def composed():
            x32 = xf.float()
            s = im._quant_scale(x32.abs().max())
            return im.int8_matmul_arrays(im._quantize(x32, s), wq, ws, s,
                                         bias=b, out_dtype=xf.dtype)

        got = call()
        want = im._int8_matmul_reference(xq, wq, ws, xs, b, out)
        got_d, want_d = dyn(), im._dynamic_int8_reference(xf, wq, ws, b)
        torch.cuda.synchronize()
        identical = bool(torch.equal(got, want))
        identical_d = bool(torch.equal(got_d, want_d)) \
            and bool(torch.equal(composed(), want_d))
        err = (got.float() - want.float()).abs().max().item()
        err_d = (got_d.float() - want_d.float()).abs().max().item()
        n_call, n_dyn = launches(call), launches(dyn)
        Mp = -(-M // 32) * 32
        xpad = torch.zeros((Mp, K), dtype=torch.int8, device=dev)
        xpad[:M] = xq
        xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
        ob = torch.tensor([], dtype=out).element_size()
        nbytes = M * K + K * N + 4 * N + 4 * xs.numel() + M * N * ob \
            + (4 * N if with_bias else 0)
        b_ms, b_by = bound(2 * M * K * N, nbytes, torch.int8)
        # the fused entry reads bf16 activations and writes bf16
        db_ms, db_by = bound(2 * M * K * N, 2 * M * K + K * N + 4 * N
                             + 2 * M * N + (4 * N if with_bias else 0),
                             torch.int8)
        ok = identical and identical_d and n_call == 1 and n_dyn <= 2
        row = {"phase": "int8_matmul", "M": M, "K": K, "N": N,
               "bias": with_bias, "per_row_scales": per_row,
               "out_dtype": str(out)[6:],
               "bit_identical": identical, "max_abs_err": err,
               "ms": time_ms(call, flush=flush),
               "kernel_ms": _kernel_device_ms(call, ("int8_mm",), flush),
               "batch_ms": batch_ms(call),
               "plain_ms": time_ms(lambda: im._int8_matmul_reference(
                   xq, wq, ws, xs, b, out), flush=flush),
               # torch._int_mm takes K and N that are multiples of 8
               "library_ms": time_ms(lambda: torch._int_mm(xpad, wq),
                                     flush=flush)
               if K % 8 == 0 and N % 8 == 0 else None,
               "library": "torch._int_mm, rows padded to 32",
               "bf16_matmul_ms": time_ms(lambda: xb @ wb, flush=flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "launches_per_call": n_call,
               "fused_quant": {
                   "x_dtype": "bfloat16", "bit_identical": identical_d,
                   "max_abs_err": err_d, "launches_per_call": n_dyn,
                   "ms": time_ms(dyn, flush=flush),
                   # each kernel's own time; they overlap (the product's
                   # weight loads start while the codes are made)
                   "kernels_ms": {
                       k: _kernel_device_ms(dyn, (k,), flush)
                       for k in ("int8_quantize", "int8_mm")},
                   "batch_ms": batch_ms(dyn),
                   "composed_ms": time_ms(composed, flush=flush),
                   "composed_batch_ms": batch_ms(composed),
                   "plain_ms": time_ms(lambda: im._dynamic_int8_reference(
                       xf, wq, ws, b), flush=flush),
                   "bound_ms": db_ms, "bound_by": db_by},
               "ok": ok, **stamp}
        row["ratio_to_library"] = (row["ms"] / row["library_ms"]
                                   if row["library_ms"] else None)
        emit(row)
        if not ok:
            raise AssertionError(f"int8 kernel disagrees: {row}")
        rows[(M, K, N)] = row
        del xq, wq, xpad, xb, wb, xf
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def int8_decode_phase(dev, stamp):
    """Phase 15: one int8 decode step, kernels on the card against the
    plain versions on the CPU."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving import KVCache, cache_insert

    cfg = G.gpt_1p3b(n_layers=2, dtype=torch.float32)
    params = G.gpt_init(cfg, seed=6, device="cpu")
    qparams = G.quantize_gpt_weights(params)
    rng = np.random.default_rng(15)
    lens = [300, 47, 1]
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
               for n in lens]
    to = lambda t, d: ({k: to(v, d) for k, v in t.items()}
                       if isinstance(t, dict) else t.to(d))

    def run(device):
        p, q = to(params, device), to(qparams, device)
        cache = KVCache(cfg, n_slots=3, max_len=512, device=device)
        with torch.inference_mode():
            for slot, toks in enumerate(prompts):
                _, (ke, ve) = G.gpt_prefill(cfg, p, toks.to(device))
                cache_insert(cache.k, cache.v, slot, ke[0], ve[0])
            pos = torch.tensor(lens, dtype=torch.int32, device=device)
            tok = torch.tensor([11, 22, 33], dtype=torch.int32,
                               device=device)
            logits, _ = G.gpt_decode_step(cfg, q, (cache.k, cache.v), pos,
                                          tok)
        return logits.cpu()

    t0 = time.perf_counter()
    card = run(dev)
    t1 = time.perf_counter()
    cpu = run("cpu")
    t2 = time.perf_counter()
    rel = _rel(card, cpu)
    ok = bool(torch.isfinite(card).all()) and rel <= INT8_LOGITS_REL \
        and card.shape == (3, cfg.vocab_size)
    row = {"phase": "int8_decode_logits", "model": "gpt_1p3b", "layers": 2,
           "dtype": "float32", "lengths": lens, "max_rel_err": rel,
           "max_abs_err": (card - cpu).abs().max().item(),
           "max_abs_logit": cpu.abs().max().item(),
           "tol_rel": INT8_LOGITS_REL, "card_s": t1 - t0, "cpu_s": t2 - t1,
           "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"int8 decode on the card and the CPU "
                             f"disagree: {row}")
    return row


# phase 16: (M, K, N, bias, weight layout). "col" is the (K, N) view of an
# (N, K)-contiguous buffer, as amp/fp8.py quantizes the weight (the
# kernel reads it in place); "row" a row-major wq, which the wrapper
# transposes once per call (its time includes that copy)
FP8_SHAPES = ((8192, 2048, 8192, False, "col"),
              (8192, 2048, 8192, False, "row"),
              (8192, 8192, 2048, False, "col"),
              (8192, 8192, 2048, False, "row"),
              (1500, 2048, 8192, False, "col"),
              (1000, 2048, 1000, False, "col"),
              (100, 64, 192, True, "col"), (100, 100, 192, True, "row"))
# (name, tokens, hidden, capacity factor) of phase 19; 8 experts, top-2
GATHER_SHAPES = (("decode", 8, 2048, None), ("training", 8192, 2048, 1.25),
                 ("ragged", 100, 100, 1.25))


def fp8_phase(dev, fm, f8, stamp, shapes=FP8_SHAPES, ste=(8192, 8192, 2048)):
    """Phase 16: the fp8 matmul kernel against its plain version at the
    fp8 training path's shapes (both weight layouts), a prefill length,
    ragged M, N and K, out bf16 and f32; torch._scaled_mm as the library
    yardstick; then the STE backward's two routes for one of its
    products."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rows = {}
    for M, K, N, with_bias, layout in shapes:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        b = torch.randn(N, generator=gen, device=dev) if with_bias else None
        sx, sw = f8._jit_scale(x), f8._jit_scale(w)
        xq = f8.quantize_fp8(x, sx)
        wq = f8.quantize_fp8(w, sw, k_major=layout == "col")
        del x, w
        wcol = wq if layout == "col" else wq.t().contiguous().t()
        for out in (torch.bfloat16, torch.float32):
            got = fm.fp8_matmul_arrays(xq, wq, sx, sw, b, out_dtype=out)
            want = fm._fp8_matmul_ref(xq, wq, sx, sw, b, out)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = _rel(got, want)
            ok = rel <= FP8_TOL[out] and bool(torch.isfinite(got).all())
            extra = {}
            del got
            es = torch.finfo(out).bits // 8
            nbytes = M * K + K * N + M * N * es + 8 \
                + (4 * N if with_bias else 0)
            b_ms, b_by = bound(2 * M * K * N, nbytes, torch.float8_e4m3fn)
            lib, b_lib, lib_note = None, None, "torch._scaled_mm"
            try:
                lib_b = b.to(out) if b is not None else None
                lib_call = lambda: torch._scaled_mm(  # noqa: E731
                    xq, wcol, scale_a=sx, scale_b=sw, bias=lib_b,
                    out_dtype=out)
                ref = lib_call()
                extra["library_max_rel_err"] = _rel(ref, want)
                del ref
                lib, b_lib = time_ms(lib_call), batch_ms(lib_call)
            except RuntimeError as e:     # the yardstick only
                lib_note = f"torch._scaled_mm refused: {str(e)[:120]}"
            del want
            call = lambda: fm.fp8_matmul_arrays(  # noqa: E731
                xq, wq, sx, sw, b, out_dtype=out)
            ms, b_call = time_ms(call), batch_ms(call)
            row = {"phase": "fp8_matmul", "M": M, "K": K, "N": N,
                   "bias": with_bias, "weight_layout": layout,
                   "out_dtype": str(out)[6:],
                   "max_abs_err": err, "max_rel_err": rel,
                   "tol_rel": FP8_TOL[out], "ok": ok, "ms": ms,
                   "plain_ms": time_ms(lambda: fm._fp8_matmul_ref(
                       xq, wq, sx, sw, b, out), max_reps=10),
                   "library_ms": lib, "library": lib_note,
                   "ratio_to_library": ms / lib if lib else None,
                   "batch_ms": b_call, "library_batch_ms": b_lib,
                   "batch_ratio_to_library": b_call / b_lib if b_lib else None,
                   "bound_ms": b_ms, "bound_by": b_by, **extra, **stamp}
            emit(row)
            if not ok:
                raise AssertionError(f"fp8 kernel disagrees: {row}")
            rows[(M, K, N, out, layout)] = row
        del xq, wq, wcol
        torch.cuda.empty_cache()
    # the STE backward's dx product at the MLP's down projection, g
    # (8192, 8192) · wᵀ (8192, 2048): a bf16 GEMM with f32 output (the
    # port's route) against the f32 GEMM of the bf16-rounded operands
    M, K, N = ste
    g = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    wd = torch.randn((N, K), generator=gen, device=dev).to(torch.bfloat16)
    a = torch.mm(g, wd.t(), out_dtype=torch.float32)
    c = g.float() @ wd.float().t()
    row = {"phase": "fp8_ste_backward", "shape": [M, K, N],
           "bf16_gemm_f32_out_ms": time_ms(
               lambda: torch.mm(g, wd.t(), out_dtype=torch.float32)),
           "f32_gemm_ms": time_ms(lambda: g.float() @ wd.float().t()),
           "max_rel_diff": _rel(a, c), **stamp}
    emit(row)
    del g, wd, a, c
    torch.cuda.empty_cache()
    return rows


def _recording(module, name, record):
    """Wrap ``module.<name>`` so that each call's result is handed to
    ``record``; returns a function that restores the original."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        record(out, args)
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def _card_and_cpu(dev, cfg, params, batch, prompt):
    """One training loss and its gradients, and gpt_prefill logits, on
    ``dev`` and on the CPU from the same f32 params."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import train_step as TS

    out = {}
    for device in (dev, "cpu"):
        p = TS._map(lambda t: t.to(device).requires_grad_(True), params)
        t0 = time.perf_counter()
        loss = G.gpt_loss(cfg, p, tuple(t.to(device) for t in batch),
                          loss_chunk=128)
        loss.backward()
        with torch.inference_mode():
            logits, _ = G.gpt_prefill(cfg, TS._map(lambda t: t.detach(), p),
                                      prompt.to(device))
        out[str(device)] = (float(loss.detach()),
                            {"/".join(k): t.grad.cpu()
                             for k, t in TS._paths(p)},
                            logits.cpu(), time.perf_counter() - t0)
        del p, loss, logits
    return out[str(dev)], out["cpu"]


def fp8_check_phase(dev, stamp):
    """Phase 18: an fp8 training step's loss and gradients, and the
    fixed-slot prefill's logits, on the card (the fp8 kernel) against the
    CPU (its plain version), full gpt_1p3b width, 2 layers, f32; with
    the share of e4m3 activation codes that differ."""
    from paddle_tpu_torch.amp import fp8 as F8
    from paddle_tpu_torch.models import gpt as G

    cfg = G.gpt_1p3b(n_layers=2, dtype=torch.float32, fp8=True, remat=True)
    params = G.gpt_init(cfg, seed=8, device="cpu")
    rng = np.random.default_rng(18)
    batch = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    # per fp8 matmul the activation is quantized first, then the weight:
    # 2 layers x 2 matmuls x (forward, remat recompute, prefill) on each
    # device, the card's calls first
    half = 2 * 2 * 3 * 2
    codes, first_cpu = [], []

    def record(q, args):
        codes.append(q.view(torch.uint8).cpu())
        if len(codes) == half + 1:          # the CPU run's first call
            first_cpu.extend(a.detach().cpu() for a in args)

    restore = _recording(F8, "quantize_fp8", record)
    try:
        (l_card, g_card, lg_card, t_card), (l_cpu, g_cpu, lg_cpu, t_cpu) = \
            _card_and_cpu(dev, cfg, params, batch, prompt)
    finally:
        restore()
    if len(codes) != 2 * half:
        raise AssertionError(f"{len(codes)} fp8 quantizations, not "
                             f"{2 * half}")
    acts = [(a, b) for a, b in zip(codes[:half][0::2], codes[half:][0::2])]
    share = [int((a != b).sum()) / a.numel() for a, b in acts]
    total = sum(a.numel() for a, _ in acts)
    differ = sum(sh * a.numel() for sh, (a, _) in zip(share, acts))
    # the first activation the CPU quantized, quantized again on the card
    x_cpu, s_cpu = first_cpu
    same_codes = torch.equal(
        F8.quantize_fp8(x_cpu.to(dev), s_cpu.to(dev)).view(torch.uint8)
        .cpu(), codes[half])
    rel = {k: _rel(g_card[k], g) for k, g in g_cpu.items()}
    rel_logits = _rel(lg_card, lg_cpu)
    tol = FP8_CHECK_TOL
    ok = abs(l_card - l_cpu) <= tol["loss"] \
        and all(r <= tol["grad"] for r in rel.values()) \
        and rel_logits <= tol["logits"] and same_codes
    row = {"phase": "fp8_grads", "model": "gpt_1p3b", "layers": 2,
           "dtype": "float32", "batch": [1, 256], "loss_card": l_card,
           "loss_cpu": l_cpu, "max_rel_err": rel,
           "prefill_logits_rel_err": rel_logits,
           "same_input_same_codes": same_codes,
           "activation_codes_compared": total,
           "activation_codes_differing_share": differ / max(total, 1),
           "differing_share_by_call": share,
           "tol": tol, "card_s": t_card, "cpu_s": t_cpu, "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"fp8 on the card and the CPU disagree: {row}")
    return row


def gather_cases(dev, shapes=GATHER_SHAPES, seed=19):
    """Phase 19's inputs, one dict a (shape, dtype): x and the src of a
    real top-2 routing (8 experts, a random router), with the bytes the
    gather must move. Each distinct live source row is read once (a token
    routed to two experts feeds two slots from one row), every slot is
    written once, and src is read."""
    from paddle_tpu_torch.nn import moe as MO

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for dtype in (torch.bfloat16, torch.float32):
        for name, T, H, cf in shapes:
            if name == "ragged" and dtype == torch.bfloat16:
                continue
            x = torch.randn((T, H), generator=gen, device=dev).to(dtype)
            router = torch.randn((H, 8), generator=gen, device=dev)
            src = MO.moe_route(router, x, top_k=2, capacity_factor=cf)[2]
            N = src.shape[0]
            live = src[(src >= 0) & (src < T)]
            distinct = int(torch.unique(live).numel())
            yield {"shape": name, "dtype": dtype, "T": T, "N": N, "H": H,
                   "x": x, "src": src, "live_slots": int(live.numel()),
                   "distinct_rows": distinct,
                   "nbytes": (distinct + N) * H * x.element_size() + 4 * N}


def gather_times(md, c, flush_buf):
    """One phase-19 case's times: lone calls (CUDA events, host work held,
    after a dirty L2 flush) of the gather and of torch.index_select (the
    same rows, empty slots not zeroed), and each one's kernel alone
    (torch.profiler) after a dirty and after a clean flush, with the
    records a call the dirty reading's trace kept."""
    x, src = c["x"], c["src"]
    idx = src.clamp_min(0).long()
    gather = lambda: md.moe_dispatch_gather(x, src)  # noqa: E731
    library = lambda: torch.index_select(x, 0, idx)  # noqa: E731
    row = {"ms": time_ms(gather, flush=flush_buf.zero_),
           "library_ms": time_ms(library, flush=flush_buf.zero_),
           "library": "torch.index_select (no zeroing)"}
    clean = l2_flushes(flush_buf)["_clean"]
    for key, fn, names in (
            ("kernel", gather, ("moe_gather",)),
            ("library_kernel", library,
             ("vectorized_gather", "index_select", "indexSelect"))):
        ms, _, records = _kernel_device_ms(fn, names, flush_buf.zero_,
                                           counts=True)
        row.update({key + "_ms": ms, key + "_records_per_call": records,
                    key + "_ms_clean": _kernel_device_ms(fn, names, clean)})
    return row


def gather_phase(dev, md, stamp, shapes=GATHER_SHAPES):
    """Phase 19: the MoE dispatch gather against its plain version
    (bit-identical) at the decode, training and a ragged shape, with the
    src of a real top-2 routing; torch.index_select as the yardstick."""
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for c in gather_cases(dev, shapes):
        x, src, dtype = c["x"], c["src"], c["dtype"]
        got = md.moe_dispatch_gather(x, src)
        want = md._gather_reference(x, src)
        torch.cuda.synchronize()
        identical = bool(torch.equal(got, want))
        err = (got.float() - want.float()).abs().max().item()
        b_ms, b_by = bound(0, c["nbytes"], dtype)
        row = {"phase": "moe_dispatch_gather",
               **{k: c[k] for k in ("shape", "T", "N", "H", "live_slots",
                                    "distinct_rows")},
               "dtype": str(dtype)[6:], "bit_identical": identical,
               "max_abs_err": err, "ok": identical,
               "plain_ms": time_ms(lambda: md._gather_reference(x, src),
                                   flush=flush_buf.zero_),
               **gather_times(md, c, flush_buf),
               "bound_ms": b_ms, "bound_by": b_by, **stamp}
        emit(row)
        if not identical:
            raise AssertionError(f"gather kernel disagrees: {row}")
        rows[(c["shape"], dtype)] = row
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def moe_check_phase(dev, stamp):
    """Phase 21: a MoE decode step and a training step on the card (the
    kernels) against the CPU (the plain versions), full gpt_1p3b width, 2
    layers (layer 1 the MoE one, 8 experts, top-2), f32: every routing
    decision (slots, src) identical, logits and gradients within the
    dense model's tolerances."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.nn import moe as MO
    from paddle_tpu_torch.serving import KVCache, cache_insert

    cfg = G.gpt_1p3b(n_layers=2, dtype=torch.float32, moe_experts=8,
                     remat=True)
    params = G.gpt_init(cfg, seed=9, device="cpu")
    rng = np.random.default_rng(21)
    batch = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256)))
    lens = [300, 47, 1]
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
               for n in lens]
    routes = []
    restore = _recording(MO, "moe_route", lambda r, _: routes.append(
        (r[1].cpu(), r[2].cpu())))

    def decode(device):
        p = {k: ({kk: vv.to(device) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in params.items()}
        cache = KVCache(cfg, n_slots=3, max_len=512, device=device)
        with torch.inference_mode():
            for slot, toks in enumerate(prompts):
                _, (ke, ve) = G.gpt_prefill(cfg, p, toks.to(device))
                cache_insert(cache.k, cache.v, slot, ke[0], ve[0])
            logits, _, (counts, dropped) = G.gpt_decode_step(
                cfg, p, (cache.k, cache.v),
                torch.tensor(lens, dtype=torch.int32, device=device),
                torch.tensor([11, 22, 33], dtype=torch.int32,
                             device=device))
        return logits.cpu(), counts.cpu(), int(dropped)

    try:
        n0 = len(routes)
        d_card = decode(dev)
        n1 = len(routes)
        d_cpu = decode("cpu")
        dec_routes = (routes[n0:n1], routes[n1:])
        routes.clear()
        (l_card, g_card, lg_card, t_card), (l_cpu, g_cpu, lg_cpu, t_cpu) = \
            _card_and_cpu(dev, cfg, params, batch, prompt)
    finally:
        restore()
    half = len(routes) // 2
    same = lambda xs, ys: len(xs) == len(ys) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(xs, ys))
    routing_identical = same(*dec_routes) and len(routes) == 2 * half \
        and same(routes[:half], routes[half:])
    rel = {k: _rel(g_card[k], g) for k, g in g_cpu.items()}
    tol = {k: TRAIN_GRAD_TOL["wte" if k == "wte" else "other"] for k in rel}
    dec_err = (d_card[0] - d_cpu[0]).abs().max().item()
    ok = routing_identical and torch.equal(d_card[1], d_cpu[1]) \
        and d_card[2] == d_cpu[2] == 0 and dec_err <= LOGITS_TOL \
        and abs(l_card - l_cpu) <= 1e-4 \
        and all(rel[k] <= tol[k] for k in rel) \
        and _rel(lg_card, lg_cpu) <= LOGITS_TOL
    row = {"phase": "moe_grads", "model": "gpt_1p3b", "layers": 2,
           "moe_experts": 8, "dtype": "float32", "lengths": lens,
           "routing_identical": routing_identical,
           "route_calls": len(dec_routes[0]) + half,
           "decode_counts": d_card[1].tolist(),
           "decode_max_abs_err": dec_err, "loss_card": l_card,
           "loss_cpu": l_cpu, "max_rel_err": rel, "tol_rel": tol,
           "prefill_logits_rel_err": _rel(lg_card, lg_cpu),
           "logits_tol": LOGITS_TOL, "card_s": t_card, "cpu_s": t_cpu,
           "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"MoE on the card and the CPU disagree: {row}")
    return row


# --------------------------------------------------------------------------
# phases 23-25: the add-LN kernels and BERT-base through the Paddle API
# --------------------------------------------------------------------------

def bert_model(paddle, vocab, hidden, layers, heads, ffn, seq):
    """A BERT-style post-LN encoder with a vocabulary head, built the way
    a Paddle user builds it: word + position ``nn.Embedding`` →
    ``nn.TransformerEncoder`` of post-LN ``TransformerEncoderLayer``s
    (gelu, dropout 0) → ``nn.Linear`` to the vocabulary. ``paddle`` is
    either package's Paddle surface (``paddle_tpu`` or
    ``paddle_tpu_torch``), so the tests build the same model on both."""
    nn = paddle.nn

    class BertLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(vocab, hidden)
            self.pos = nn.Embedding(seq, hidden)
            self.encoder = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(hidden, heads, ffn, dropout=0.0,
                                           activation="gelu"), layers)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, ids):
            x = self.word(ids) + self.pos(paddle.arange(ids.shape[1]))
            return self.head(self.encoder(x))

    return BertLM()


def fused_layer_params(paddle, layer):
    """A composed ``TransformerEncoderLayer``'s parameters as the fused
    ops' arguments: ``qkv_w`` (d, 3d) = [q | k | v] weights, ``qkv_b``,
    the output projection, ``norm1`` (the attention's post-LN), the two
    FFN linears and ``norm2``."""
    a = layer.self_attn
    with paddle.no_grad():
        return {
            "qkv_w": paddle.concat([a.q_proj.weight, a.k_proj.weight,
                                    a.v_proj.weight], axis=1),
            "qkv_b": paddle.concat([a.q_proj.bias, a.k_proj.bias,
                                    a.v_proj.bias]),
            "out_w": a.out_proj.weight, "out_b": a.out_proj.bias,
            "ln1_w": layer.norm1.weight, "ln1_b": layer.norm1.bias,
            "w1": layer.linear1.weight, "b1": layer.linear1.bias,
            "w2": layer.linear2.weight, "b2": layer.linear2.bias,
            "ln2_w": layer.norm2.weight, "ln2_b": layer.norm2.bias}


def bert_fused_model(paddle, composed):
    """:func:`bert_model`'s model with each encoder layer's halves
    replaced by ``fused_multi_head_attention`` and ``fused_feedforward``
    (both post-LN, gelu), holding copies of ``composed``'s current
    weights."""
    nn = paddle.nn
    heads = composed.encoder.layers[0].self_attn.num_heads

    class FusedEncoderLayer(nn.Layer):
        def __init__(self, src):
            super().__init__()
            for name, value in fused_layer_params(paddle, src).items():
                p = self.create_parameter(value.shape,
                                          is_bias=len(value.shape) == 1)
                p.set_value(value)
                setattr(self, name, p)

        def forward(self, x):
            x = paddle.ops.fused_multi_head_attention(
                x, self.qkv_w, self.qkv_b, self.out_w, self.out_b,
                self.ln1_w, self.ln1_b, heads, pre_layer_norm=False)
            return paddle.ops.fused_feedforward(
                x, self.w1, self.b1, self.w2, self.b2, self.ln2_w,
                self.ln2_b, pre_layer_norm=False, activation="gelu")

    class FusedBertLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(*composed.word.weight.shape)
            self.pos = nn.Embedding(*composed.pos.weight.shape)
            self.layers = nn.LayerList(
                [FusedEncoderLayer(src) for src in composed.encoder.layers])
            self.head = nn.Linear(*composed.head.weight.shape)
            for mine, src in ((self.word, composed.word),
                              (self.pos, composed.pos),
                              (self.head, composed.head)):
                mine.set_state_dict(src.state_dict())

        def forward(self, ids):
            x = self.word(ids) + self.pos(paddle.arange(ids.shape[1]))
            for layer in self.layers:
                x = layer(x)
            return self.head(x)

    return FusedBertLM()


def _kernel_device_ms(fn, names, flush, reps=10, counts=False):
    """Device time per call of the kernels whose names contain one of
    ``names``, from torch.profiler over ``reps`` calls (the L2 flushed
    before each): the kernels' own time, without the host's enqueue.
    Each kernel is read as its mean time a launch and the kernels of a
    call are summed (every caller's kernels launch once a call): late in
    a long process the trace can keep only some of a kernel's records,
    and a total over ``reps`` would read that as a faster kernel.
    ``counts``: (that time, the distinct kernels a call, the records a
    call the trace kept)."""
    from paddle_tpu_torch.tools.profile_decode import _device_us

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(n in e.key for n in names) and e.count]
    if not events:
        return (None, None, None) if counts else None   # the trace lost them
    ms = sum(_device_us(e) / e.count for e in events) / 1e3
    if counts:
        return ms, len(events), sum(e.count for e in events) / reps
    return ms


def addln_phase(dev, fk, stamp):
    """Phase 23: the add-LN kernels against their plain versions."""
    from paddle_tpu_torch.ops import _build

    emit({"phase": "fused_add_ln_build", "ptxas": [
        ln.strip() for ln in _build.build_log("fused_add_ln").splitlines()
        if "registers" in ln or "spill" in ln], **stamp})
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    shapes = ((16384, 768, torch.float32), (16384, 768, torch.bfloat16),
              (8192, 2048, torch.bfloat16), (1000, 776, torch.bfloat16),
              (1000, 130, torch.float32))
    for R, H, dtype in shapes:
        n = lambda *sh, sc=1.0: torch.randn(sh, generator=gen,
                                            device=dev) * sc
        x, y, do = n(R, H).to(dtype), n(R, H).to(dtype), n(R, H).to(dtype)
        s, b = 1.0 + n(H, sc=0.1), n(H, sc=0.1)
        fwd = lambda: fk._addln_launch_fwd(x, y, s, b, 1e-5)
        fwd_ref = lambda: fk._addln_forward_reference(x, y, s, b, 1e-5)
        got, want = fwd(), fwd_ref()
        mu, rstd = want[1], want[2]
        bwd = lambda: fk._addln_launch_bwd(x, y, s, mu, rstd, do)
        bwd_ref = lambda: fk._addln_backward_reference(x, y, s, mu, rstd,
                                                       do)
        got_b, want_b = bwd(), bwd_ref()
        torch.cuda.synchronize()
        errs = {nm: _rel(g, w) for nm, g, w in zip(
            ("out", "mu", "rstd", "dx", "ds", "db"), got + got_b,
            want + want_b)}
        abs_errs = {nm: (g.float() - w.float()).abs().max().item()
                    for nm, g, w in zip(("out", "dx"), (got[0], got_b[0]),
                                        (want[0], want_b[0]))}
        ok = max(errs.values()) <= ADDLN_TOL[dtype]
        es = x.element_size()
        # forward: read x, y, s, b; write out, mu, rstd. Backward: read x,
        # y, do, s, mu, rstd; write dx, ds, db. ~9 and ~16 f32 operations
        # an element (CUDA cores)
        f_ms, f_by = bound(9 * R * H, 3 * R * H * es + 8 * H + 8 * R,
                           torch.float32)
        b_ms, b_by = bound(16 * R * H, 4 * R * H * es + 12 * H + 8 * R,
                           torch.float32)
        # yardstick: x + y then F.layer_norm, and its autograd backward
        xs, ys = (t.detach().requires_grad_(True) for t in (x, y))
        ss, bs = (t.detach().to(dtype).requires_grad_(True) for t in (s, b))
        comp = lambda: F.layer_norm(xs + ys, (H,), ss, bs, 1e-5)
        out_c = comp()
        row = {"phase": "fused_add_ln", "R": R, "H": H,
               "dtype": str(dtype)[6:], "max_rel_err": errs,
               "max_abs_err_out": abs_errs["out"],
               "max_abs_err_dx": abs_errs["dx"], "tol_rel": ADDLN_TOL[dtype],
               "ok": ok,
               "fwd_ms": time_ms(fwd, flush=flush_buf.zero_),
               "fwd_plain_ms": time_ms(fwd_ref, flush=flush_buf.zero_),
               "fwd_kernel_ms": _kernel_device_ms(
                   fwd, ("addln_fwd",), flush_buf.zero_),
               "fwd_bound_ms": f_ms, "fwd_bound_by": f_by,
               "fwd_composed_ms": time_ms(comp, flush=flush_buf.zero_),
               "bwd_ms": time_ms(bwd, flush=flush_buf.zero_),
               "bwd_plain_ms": time_ms(bwd_ref, flush=flush_buf.zero_),
               "bwd_kernel_ms": _kernel_device_ms(
                   bwd, ("addln_bwd",), flush_buf.zero_),
               "bwd_bound_ms": b_ms, "bwd_bound_by": b_by,
               "bwd_composed_ms": time_ms(
                   lambda: torch.autograd.grad(out_c, [xs, ys, ss, bs], do,
                                               retain_graph=True),
                   flush=flush_buf.zero_),
               **stamp}
        emit(row)
        if not ok:
            raise AssertionError(f"add-LN kernels disagree: {row}")
        rows[(R, H, dtype)] = row
        del x, y, do, got, want, got_b, want_b, xs, ys, out_c
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def _bert_counts(fa, fk, fo):
    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "fused_ln_mlp_fwd": fk.FWD_LAUNCHES,
            "fused_ln_mlp_bwd": fk.BWD_LAUNCHES,
            "fused_ln_mlp_bwd_dw2": fk.DW2_LAUNCHES,
            "fused_add_ln_fwd": fk.ADDLN_FWD_LAUNCHES,
            "fused_add_ln_bwd": fk.ADDLN_BWD_LAUNCHES,
            "fused_adamw": fo.ADAMW_LAUNCHES}


def _reset_bert_counts(fa, fk, fo):
    _reset_training_counts(fa, fk)
    fk.ADDLN_FWD_LAUNCHES = fk.ADDLN_BWD_LAUNCHES = 0
    fo.ADAMW_LAUNCHES = 0


def _bert_train(paddle, model, ids, labels, steps, dev, counts):
    """Eager AdamW steps (``loss.backward(); opt.step();
    opt.clear_grad()``): losses, host ms per step (ending in the loss's
    read), CUDA-event ms per step, peak memory, and each kernel's
    launches over the run (``counts`` set to 0 just before it); then one
    more step under torch.profiler: the summed kernel time and the
    kernels that take the most of it."""
    from paddle_tpu_torch.tools.profile_decode import _device_us

    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=model.parameters())

    def step():
        loss = paddle.nn.functional.cross_entropy(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)            # the host read syncs the step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, host_ms, dev_ms = [], [], []
    reset, read = counts
    reset()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses.append(step())
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and _device_us(e) > 0), reverse=True)
    return {"losses": losses, "step_ms": host_ms, "device_ms": dev_ms,
            "peak_mem_gib": peak, "launches": launches,
            "profiled_kernel_ms": sum(r[0] for r in rows) / 1e3,
            "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                            for us, k, c in rows[:10]]}


def bert_train_phase(dev, fa, fk, fo, stamp, steps=6):
    """Phase 24: BERT-base trained through the Paddle API, (a) composed
    with both flags 0, (b) fused with FLAGS_fused_kernels=1 and
    FLAGS_fused_optimizer=1 from (a)'s initial weights."""
    import paddle_tpu_torch as paddle

    cfg = BERT_BASE
    B, S = BERT_BATCH, cfg["seq"]
    paddle.set_device("gpu")
    paddle.seed(24)
    composed = bert_model(paddle, **cfg)
    fused = bert_fused_model(paddle, composed)
    rng = np.random.default_rng(24)
    ids = paddle.to_tensor(rng.integers(0, cfg["vocab"], (B, S)))
    labels = paddle.to_tensor(rng.integers(0, cfg["vocab"], (B, S)))
    n_params = sum(p.size for p in composed.parameters())
    counts = (lambda: _reset_bert_counts(fa, fk, fo),
              lambda: _bert_counts(fa, fk, fo))
    flags = ("FLAGS_fused_kernels", "FLAGS_fused_optimizer")
    runs = {}
    for name, model, on in (("composed", composed, 0), ("fused", fused, 1)):
        paddle.set_flags({f: on for f in flags})
        try:
            run = _bert_train(paddle, model, ids, labels, steps, dev, counts)
        finally:
            paddle.set_flags({f: 0 for f in flags})
        step_ms = float(np.median(run["step_ms"][-3:]))
        run.update({
            "phase": f"train_paddle_bert_{name}", "model": "bert_base",
            "layers": cfg["layers"], "hidden": cfg["hidden"],
            "batch": [B, S], "dtype": "float32", "params": n_params,
            "optimizer": "AdamW(lr=1e-4, weight_decay=0.01)",
            "flags": {f: on for f in flags}, "steps": steps,
            "step_ms_median_last3": step_ms,
            "device_ms_median_last3": float(np.median(run["device_ms"][-3:])),
            "tokens_per_s": B * S / step_ms * 1e3,
            "launches_per_step": {k: v / steps
                                  for k, v in run["launches"].items()}})
        runs[name] = run
        torch.cuda.empty_cache()
    a, b = runs["composed"], runs["fused"]
    first_rel = abs(b["losses"][0] - a["losses"][0]) / abs(a["losses"][0])
    fused_kernels = ("flash_attention_fwd", "flash_attention_bwd",
                     "fused_ln_mlp_fwd", "fused_ln_mlp_bwd",
                     "fused_ln_mlp_bwd_dw2", "fused_adamw")
    ok = {
        "losses_finite": all(math.isfinite(x)
                             for x in a["losses"] + b["losses"]),
        "losses_fall": a["losses"][-1] < a["losses"][0]
        and b["losses"][-1] < b["losses"][0],
        "first_loss_rel": first_rel <= BERT_FIRST_LOSS_REL,
        "add_ln_12_a_step": b["launches"]["fused_add_ln_fwd"]
        == b["launches"]["fused_add_ln_bwd"] == cfg["layers"] * steps,
        "fused_kernels_launched": all(b["launches"][k] > 0
                                      for k in fused_kernels),
        "composed_takes_flash": a["launches"]["flash_attention_fwd"] > 0
        and a["launches"]["fused_add_ln_fwd"] == 0}
    for run in (a, b):
        run.update({"first_loss_rel_to_composed": first_rel,
                    "tol_first_loss_rel": BERT_FIRST_LOSS_REL,
                    "checks": ok, "ok": all(ok.values()), **stamp})
        emit(run)
    if not all(ok.values()):
        raise AssertionError(f"BERT training phase failed: {ok}")
    del composed, fused
    torch.cuda.empty_cache()
    return runs


def bert_check_phase(dev, stamp, layers=2, batch=2):
    """Phase 25: the fused encoder at full width, ``layers`` blocks, f32,
    one step's loss and every parameter's gradient on the card (the
    kernels) against the CPU (the plain versions)."""
    import paddle_tpu_torch as paddle

    cfg = dict(BERT_BASE, layers=layers)
    rng = np.random.default_rng(25)
    ids_np = rng.integers(0, cfg["vocab"], (batch, cfg["seq"]))
    labels_np = rng.integers(0, cfg["vocab"], (batch, cfg["seq"]))
    paddle.set_flags({"FLAGS_fused_kernels": 1})
    try:
        paddle.set_device("cpu")
        paddle.seed(25)
        model = bert_fused_model(paddle, bert_model(paddle, **cfg))
        out = {}
        for where in ("cpu", "gpu"):
            paddle.set_device(where)
            model.to(device=where)
            t0 = time.perf_counter()
            loss = paddle.nn.functional.cross_entropy(
                model(paddle.to_tensor(ids_np)),
                paddle.to_tensor(labels_np))
            loss.backward()
            out[where] = (float(loss), {n: p.grad._data.cpu()
                                        for n, p in model.named_parameters()},
                          time.perf_counter() - t0)
            model.clear_gradients()
    finally:
        paddle.set_flags({"FLAGS_fused_kernels": 0})
        paddle.set_device("gpu")
    (l_cpu, g_cpu, s_cpu), (l_card, g_card, s_card) = out["cpu"], out["gpu"]
    rel = {n: _rel(g_card[n], g) for n, g in g_cpu.items()}
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    ok = loss_rel <= BERT_CHECK_TOL["loss"] \
        and max(rel.values()) <= BERT_CHECK_TOL["grad"]
    row = {"phase": "paddle_bert_card_vs_cpu", "model": "bert_base",
           "layers": layers, "batch": [batch, cfg["seq"]], "dtype": "float32",
           "loss_card": l_card, "loss_cpu": l_cpu, "loss_rel_err": loss_rel,
           "max_rel_err_grad": max(rel.values()), "rel_err_grads": rel,
           "tol": BERT_CHECK_TOL, "card_s": s_card, "cpu_s": s_cpu,
           "ok": ok, **stamp}
    emit(row)
    if not ok:
        raise AssertionError(f"BERT card and CPU disagree: {row}")
    return row


# --------------------------------------------------------------------------
# phases 26-29: speculative decoding, the prefix cache, text and constraints
# --------------------------------------------------------------------------

SPEC_K = 4
# the f32 identity checks run gpt_1p3b's full width at this depth
IDENTITY_LAYERS = 4
# phase 26: a draft equal to the f32 target is rejected only at a
# near-tie of its argmax, so it must have at least this share of its
# proposals accepted, and of the rows' speculative ticks emit more than
# one token
SELF_DRAFT_MIN = 0.9
# phases 26 and 28: two f32 engines' greedy streams may part only at a
# near-tie, where the target's top two logits lie within this share of
# the top logit (f32 sums in another order can flip such an argmax)
TIE_REL = 1e-4
# phase 29: the text front end's merges and one bounded constraint (its
# automaton must finish within TEXT_NEW tokens)
TEXT_MERGES = ["yes", "no", ", ", "the ", "ing", "and", "er", "Answer"]
TEXT_REGEX = r"(yes|no), [0-9]{1,3}\."
TEXT_NEW = 16


def _scaled_params(G, cfg, dev):
    """gpt_init from seed 0 with the block matrices scaled x4, so that
    random-weight greedy streams vary from token to token."""
    params = G.gpt_init(cfg, seed=0, device=dev)
    for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
        params["blocks"][k] *= 4.0
    return params


def _streams_equal(G, cfg, params, prompts, want, got, dev):
    """Compare two engines' greedy streams; a stream pair that parts must
    part at a near-tie of the f32 target (TIE_REL), else the run fails.
    Returns (equal streams, [(request, index, relative top-2 gap)])."""
    ties = []
    for r, (prompt, a, b) in enumerate(zip(prompts, want, got)):
        if a == b:
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        toks = np.concatenate([prompt, np.asarray(a[:i], np.int32)])
        with torch.inference_mode():
            x, _ = G.prefill_hidden(cfg, params, torch.from_numpy(
                toks[None].astype(np.int64)).to(dev))
            top = G._head(cfg, params, x[:, -1])[0].topk(2).values
        gap = float((top[0] - top[1]) / top[0].abs())
        ties.append((r, i, gap))
        if gap >= TIE_REL:
            raise AssertionError(
                f"streams of request {r} part at token {i}, where the "
                f"target's top-2 gap is {gap:.3e} of the top logit")
    return len(prompts) - len(ties), ties


def _generate(eng, prompts, new, **kw):
    reqs = [eng.submit(p, max_new_tokens=new, **kw) for p in prompts]
    try:
        return [r.result(timeout=600) for r in reqs]
    finally:
        eng.shutdown()


def _count_bursts(eng):
    """Histogram of the tokens each active row emits per speculative tick
    (index n: rows that emitted n, 1..k+1), filled on the scheduler
    thread by wrapping the engine's speculative dispatch."""
    bursts = [0] * (eng.spec_k + 2)
    dispatch = eng._spec_dispatch

    def counted(*args):
        out, n_emit, health = dispatch(*args)
        for s, st in enumerate(eng._slots):
            if st is not None and st.pending is None:
                bursts[int(n_emit[s])] += 1
        return out, n_emit, health

    eng._spec_dispatch = counted
    return bursts


def spec_identity_phase(dev, stamp):
    """Phase 26: greedy streams of the speculative engine equal the
    non-speculative engine's, f32 (TF32 off), gpt_1p3b's full width at
    IDENTITY_LAYERS layers, both cache modes, with a draft that agrees
    with the target (its own layers: bursts of k+1) and one that mostly
    does not (2 layers)."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    cfg = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    params = _scaled_params(G, cfg, dev)
    drafts = {n: G.gpt_truncate(cfg, params, n) for n in (IDENTITY_LAYERS, 2)}
    prompts = _greedy(phase5_requests(cfg.vocab_size, seed=8))
    new = 32
    rows = []
    for paged in (False, True):
        want = _generate(InferenceEngine(cfg, params, n_slots=8,
                                         paged=paged), prompts, new)
        for n_draft, draft in drafts.items():
            s0 = (stat_get("spec_proposed"), stat_get("spec_accepted"))
            eng = InferenceEngine(cfg, params, n_slots=8, paged=paged,
                                  draft=draft, spec_k=SPEC_K)
            bursts = _count_bursts(eng)
            got = _generate(eng, prompts, new)
            proposed = stat_get("spec_proposed") - s0[0]
            accepted = stat_get("spec_accepted") - s0[1]
            equal, ties = _streams_equal(G, cfg, params, prompts, want, got,
                                         dev)
            rate = accepted / max(proposed, 1)
            multi = sum(bursts[2:]) / max(sum(bursts), 1)
            row = {"phase": "spec_identity", "mode": "paged" if paged
                   else "fixed", "model": "gpt_1p3b", "dtype": "float32",
                   "layers": cfg.n_layers, "hidden": cfg.hidden,
                   "draft_layers": n_draft, "spec_k": SPEC_K,
                   "requests": len(prompts), "new_tokens": new,
                   "streams_equal": equal, "near_ties": ties,
                   "tie_rel": TIE_REL,
                   "distinct_tokens": len({t for o in want for t in o}),
                   "spec_acceptance_rate": rate, "bursts": bursts,
                   "multi_token_tick_share": multi, **stamp}
            emit(row)
            if n_draft == cfg.n_layers and (rate < SELF_DRAFT_MIN
                                            or multi < SELF_DRAFT_MIN):
                raise AssertionError(
                    f"the target's own layers as the draft: acceptance "
                    f"{rate:.3f}, multi-token tick share {multi:.3f}, "
                    f"below {SELF_DRAFT_MIN}")
            rows.append(row)
    del params, drafts
    torch.cuda.empty_cache()
    return rows


def _launches_per_tick(make_engine, prompts, ticks=10):
    """Device kernels launched per decode tick of a live engine, from
    torch.profiler over ``ticks`` ticks once every request has its first
    token (prefill done): every kernel of the tick, the PyTorch ones
    included. The profiler starts and stops on the scheduler thread,
    around its own ticks (profiling it from another thread while it
    launches crashed the process on the card). None when the trace holds
    no device kernel."""
    from paddle_tpu_torch.tools.profile_decode import _device_us

    eng = make_engine()
    reqs = [eng.submit(p, max_new_tokens=256) for p in prompts]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    state = {"prof": None, "n": 0}
    done = threading.Event()
    tick = eng._decode_tick

    def profiled_tick():
        if state["prof"] is None and all(r.tokens for r in reqs):
            state["prof"] = torch.profiler.profile(activities=acts)
            state["prof"].__enter__()
        tick()
        if state["prof"] is not None and not done.is_set():
            state["n"] += 1
            if state["n"] == ticks:
                torch.cuda.synchronize()
                state["prof"].__exit__(None, None, None)
                done.set()

    eng._decode_tick = profiled_tick
    try:
        if not done.wait(300):
            raise AssertionError("the profiled ticks did not run")
    finally:
        for r in reqs:
            r.cancel()
        eng.shutdown()
    n = sum(e.count for e in state["prof"].key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0)
    return n / ticks if n else None


def spec_phase(dev, cfg, params, fa, pa, stamp):
    """Phase 27: phase 5's serving run, without and with a 2-layer
    gpt_truncate draft (SPEC_K), bf16 at full depth, both cache modes, in
    this one phase: decode tokens/s, acceptance, launches per tick."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.serving import InferenceEngine

    draft = G.gpt_truncate(cfg, params, 2)
    prompts = _greedy(phase5_requests(cfg.vocab_size))
    runs = {}
    for paged in (False, True):
        base = engine_phase(dev, cfg, params, paged, fa, pa, stamp)
        run = engine_phase(dev, cfg, params, paged, fa, pa, stamp,
                           fp_outs=base["outs"], draft=draft)
        per_tick = {
            name: _launches_per_tick(lambda kw=kw: InferenceEngine(
                cfg, params, n_slots=8, paged=paged, **kw), prompts)
            for name, kw in (("plain", {}),
                             ("spec", {"draft": draft, "spec_k": SPEC_K}))}
        row = {"phase": "spec_serving", "mode": "paged" if paged
               else "fixed", "model": "gpt_1p3b", "layers": cfg.n_layers,
               "draft_layers": 2, "spec_k": SPEC_K,
               "decode_tok_s": run["decode_tok_s"],
               "plain_decode_tok_s": base["decode_tok_s"],
               "speedup": run["decode_tok_s"] / base["decode_tok_s"],
               "spec_acceptance_rate": run["spec_acceptance_rate"],
               "launches_per_tick": per_tick["spec"],
               "plain_launches_per_tick": per_tick["plain"],
               "prefill_1500_ms": run["prefill_1500_ms"],
               "plain_prefill_1500_ms": base["prefill_1500_ms"],
               "greedy_tokens_equal_to_plain_share":
                   run["greedy_tokens_equal_to_bf16_share"], **stamp}
        emit(row)
        runs[paged] = run
    return runs


def _prefix_prompts(V):
    """Eight prompts on one 1024-token prefix with 64-400-token tails; the
    sixth keeps only the prefix's first 1000 tokens, so its match ends
    mid-block (a copy-on-write)."""
    rng = np.random.default_rng(6)
    head = rng.integers(0, V, 1024).astype(np.int32)
    tails = (64, 100, 150, 200, 250, 300, 350, 400)
    prompts = [np.concatenate([head, rng.integers(0, V, n).astype(np.int32)])
               for n in tails]
    prompts[5] = np.concatenate([head[:1000], prompts[5][1024:]])
    return prompts


def _prefix_run(eng, prompts, new):
    """The first prompt alone (it fills the tree), then the other seven at
    once. Returns (streams, prefill ms of the seven)."""
    from paddle_tpu_torch.monitor.stats import stat_get

    try:
        first = eng.generate(prompts[0], max_new_tokens=new)
        ms0 = stat_get("serving_prefill_ms")
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts[1:]]
        outs = [first] + [r.result(timeout=600) for r in reqs]
        return outs, stat_get("serving_prefill_ms") - ms0
    finally:
        eng.shutdown()


def _tree_refs_only(eng):
    blocks = eng._prefix.blocks()
    return eng.cache._refs == {b: 1 for b in blocks}


def prefix_phase(dev, cfg, params, fa, pa, stamp):
    """Phase 28: the radix prefix cache, paged. f32 identity against the
    cold engine (full width, IDENTITY_LAYERS layers); then bf16 at full
    depth: the wave's prefill ms with and without the cache, the hit
    rate, copy-on-writes, and a second pass on a pool small enough to
    evict tree leaves; every refcount the tree's own after shutdown."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    new = 32
    prompts = _prefix_prompts(cfg.vocab_size)
    cfg32 = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    p32 = _scaled_params(G, cfg32, dev)
    want, _ = _prefix_run(InferenceEngine(cfg32, p32, n_slots=8, paged=True,
                                          prefix_cache=False), prompts, new)
    eng = InferenceEngine(cfg32, p32, n_slots=8, paged=True,
                          prefix_cache=True)
    got, _ = _prefix_run(eng, prompts, new)
    equal, ties = _streams_equal(G, cfg32, p32, prompts, want, got, dev)
    ident = {"streams_equal": equal, "near_ties": ties,
             "distinct_tokens": len({t for o in want for t in o}),
             "refcounts_tree_only": _tree_refs_only(eng)}
    del p32, eng
    torch.cuda.empty_cache()

    keys = ("prefix_matched_tokens", "prefix_lookup_tokens",
            "prefix_cow_copies", "prefix_evictions", "serving_preemptions")
    cold, cold_ms = _prefix_run(InferenceEngine(
        cfg, params, n_slots=8, paged=True, prefix_cache=False), prompts, new)
    s0 = {k: stat_get(k) for k in keys}
    fa.LAUNCHES = 0
    pa.LAUNCHES = 0
    eng = InferenceEngine(cfg, params, n_slots=8, paged=True,
                          prefix_cache=True)
    warm, warm_ms = _prefix_run(eng, prompts, new)
    launches = {"flash_attention_fwd": fa.LAUNCHES,
                "paged_attention_decode": pa.LAUNCHES}
    d = {k: stat_get(k) - s0[k] for k in keys}
    refs_ok = _tree_refs_only(eng)
    tree_blocks = eng._prefix.block_count
    # the second pass: 64 blocks for the shared prefix and 96 for the
    # rest, then a prompt on another prefix — the tree must give leaves
    # back to the pool
    s1 = {k: stat_get(k) for k in keys}
    small = InferenceEngine(cfg, params, n_slots=8, paged=True,
                            prefix_cache=True, n_blocks=1 + 64 + 96)
    other = np.random.default_rng(9).integers(
        0, cfg.vocab_size, 1200).astype(np.int32)
    pressed, _ = _prefix_run(small, prompts + [other], new)
    d2 = {k: stat_get(k) - s1[k] for k in keys}
    refs_ok = refs_ok and _tree_refs_only(small)
    row = {"phase": "prefix_serving", "mode": "paged", "model": "gpt_1p3b",
           "layers": cfg.n_layers, "prefix_tokens": 1024,
           "prompt_tokens": [int(p.size) for p in prompts],
           "requests": len(prompts), "new_tokens": new,
           "identity_f32": {"layers": IDENTITY_LAYERS, **ident},
           "prefill_ms_wave": warm_ms, "cold_prefill_ms_wave": cold_ms,
           "prefill_ratio": warm_ms / max(cold_ms, 1),
           "prefix_hit_rate": d["prefix_matched_tokens"]
           / max(d["prefix_lookup_tokens"], 1),
           "prefix_cow_copies": d["prefix_cow_copies"],
           "prefix_evictions": d2["prefix_evictions"],
           "small_pool_preemptions": d2["serving_preemptions"],
           "small_pool_blocks": small.cache.n_blocks,
           "tree_blocks": tree_blocks, "refcounts_tree_only": refs_ok,
           "bf16_greedy_equal_to_cold_share": sum(
               a == b for o, c in zip(warm, cold) for a, b in zip(o, c))
           / sum(len(o) for o in cold),
           "launches": launches, **stamp}
    emit(row)
    bad = [o for o in warm + pressed
           if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o)]
    if bad or not ident["refcounts_tree_only"] or not refs_ok \
            or row["prefix_hit_rate"] <= 0 or row["prefix_cow_copies"] < 1 \
            or row["prefix_evictions"] < 1 \
            or launches["paged_attention_decode"] <= 0:
        raise AssertionError(f"prefix cache run is off: {row}")
    return row


def text_phase(dev, cfg, params, stamp):
    """Phase 29: a ByteTokenizer over TEXT_MERGES, ``submit(text=...)``
    and the bounded TEXT_REGEX constraint, greedy and sampled, both cache
    modes: every constrained stream ends with "stop" within TEXT_NEW
    tokens and its bytes fully match the DFA."""
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine
    from paddle_tpu_torch.serving.constrained import (compile_constraint,
                                                      compile_regex)
    from paddle_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer(merges=TEXT_MERGES)
    con = compile_constraint(tokenizer=tok, regex=TEXT_REGEX,
                             vocab_size=cfg.vocab_size)
    dfa = compile_regex(TEXT_REGEX)
    rows = {}
    for paged in (False, True):
        c0 = stat_get("constrained_requests")
        eng = InferenceEngine(cfg, params, n_slots=8, paged=paged, seed=7,
                              tokenizer=tok)
        try:
            reqs = [eng.submit(text=f"Question {i}: is it so? Answer: ",
                               max_new_tokens=TEXT_NEW, constraint=con,
                               temperature=0.0 if i < 4 else 0.9)
                    for i in range(8)]
            outs = [(r.text(timeout=600), r.finish_reason, r.tokens)
                    for r in reqs]
        finally:
            eng.shutdown()
        for text, reason, ids in outs:
            data = b"".join(tok.token_bytes(t) or b"" for t in ids)
            if reason != "stop" or len(ids) > TEXT_NEW \
                    or not dfa.matches(data) or data.decode() != text:
                raise AssertionError(
                    f"constrained stream off: {reason} {ids} {data!r}")
        row = {"phase": "text_constrained", "mode": "paged" if paged
               else "fixed", "model": "gpt_1p3b", "layers": cfg.n_layers,
               "regex": TEXT_REGEX, "tokenizer_vocab": tok.vocab_size,
               "texts": [o[0] for o in outs],
               "finish_reasons": [o[1] for o in outs],
               "tokens": [len(o[2]) for o in outs],
               "constrained_requests": stat_get("constrained_requests") - c0,
               **stamp}
        emit(row)
        rows[paged] = row
    return rows


# phases 30-33: the engine's resilience and observability
# --------------------------------------------------------------------------

# phases 30-33 give every request this many new tokens
RES_NEW = 16
# phase 30: the request whose K/V the serving_nan fault poisons
NAN_RID = 3
# phase 31: the 1500-token prompt's prefill chunk at rung 0 and rung 2
# (64 // OverloadController's chunk_shrink 4, on 16-token blocks)
CHUNK_RUNG0, CHUNK_RUNG2 = 64, 16
# phase 32: blocks a streamed chunk carries
STREAM_CHUNK_BLOCKS = 8


def _submit_all(eng, requests, new=RES_NEW, **kw):
    """Submit ``phase5_requests``' (prompt, sampling kwargs) pairs."""
    return [eng.submit(p, max_new_tokens=new, **skw, **kw)
            for p, skw in requests]


def _outcomes(reqs):
    """Each request's (tokens, finish_reason, error type or None)."""
    out = []
    for r in reqs:
        try:
            toks = r.result(timeout=600)
        except RuntimeError:
            toks = list(r.tokens)
        out.append((toks, r.finish_reason,
                    None if r.error is None else type(r.error).__name__))
    return out


def _hold_identity(G, cfg, params, requests, want, got, dev, skip=()):
    """Streams of two f32 runs of ``requests``: sampled streams equal,
    greedy ones equal or parted at a near-tie (TIE_REL). Returns the
    greedy comparison of ``_streams_equal``."""
    for i, (_, skw) in enumerate(requests):
        if skw and i not in skip and want[i] != got[i]:
            raise AssertionError(f"sampled stream {i} differs: {want[i]} "
                                 f"vs {got[i]}")
    idx = [i for i, (_, skw) in enumerate(requests)
           if not skw and i not in skip]
    return _streams_equal(G, cfg, params, [requests[i][0] for i in idx],
                          [want[i] for i in idx], [got[i] for i in idx], dev)


def _record_verdicts(eng):
    """Wrap the engine's decode dispatches: each tick's (time, {slot:
    rid} of the active rows, per-slot verdict) lands in the returned
    list, on the scheduler thread."""
    log = []
    for name in ("_plain_dispatch", "_spec_dispatch"):
        fn = getattr(eng, name)

        def wrapped(*args, _fn=fn):
            got = _fn(*args)
            active = {s: st.req.rid for s, st in enumerate(eng._slots)
                      if st is not None and st.pending is None}
            log.append((time.perf_counter(), active,
                        None if got[-1] is None else got[-1].copy()))
            return got

        setattr(eng, name, wrapped)
    return log


def _record_pushes(req):
    """Time every token the request receives (``req.push_times``)."""
    req.push_times = []
    push = req._push

    def timed(tok):
        req.push_times.append(time.perf_counter())
        push(tok)

    req._push = timed


def _verdict_row(log, reqs):
    """The poisoned tick of a verdict log: the slot of request NAN_RID
    must read False and every other active slot True, on that tick and
    on every tick before it."""
    for i, (t, active, health) in enumerate(log):
        bad = [s for s in active if not health[s]]
        if not bad:
            continue
        slot = next(s for s, rid in active.items() if rid == NAN_RID)
        if bad != [slot]:
            raise AssertionError(f"poisoned tick {i}: slots {bad} read "
                                 f"non-finite, want only {slot}")
        healthy = [s for s in active if s != slot]
        after = [min((p for p in reqs[active[s]].push_times if p > t),
                     default=None) for s in healthy]
        after = [p for p in after if p is not None]
        return {"poisoned_tick": i, "poisoned_slot": slot,
                "active_slots": len(active),
                "healthy_verdicts_true": len(healthy),
                "restart_to_first_token_ms":
                    (min(after) - t) * 1e3 if after else None}
    raise AssertionError("no tick read the poisoned slot non-finite")


def _fresh_peak(dev):
    """Free what earlier engines left (a wrapped engine refers to itself,
    so only the cycle collector frees it) and restart the peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def _counts(mods):
    for m in mods.values():
        m.LAUNCHES = 0


def _read(mods):
    return {k: m.LAUNCHES for k, m in mods.items()}


def watchdog_phase(dev, cfg, params, mods, stamp, flight_dir):
    """Phase 30: the serving watchdog. (1) f32 identity at full width,
    IDENTITY_LAYERS layers, 8 slots, fixed and paged, phase 5's prompts
    with FLAGS_fault_inject=serving_nan@step=NAN_RID: request NAN_RID
    ends "watchdog" (WatchdogTripped), every other stream equals the
    unarmed engine's, one trip and one restart, a
    serving_watchdog_restart flight dump that parses. (2) bf16 at full
    depth: one poisoned slot on each decode path (fixed, paged, int8
    paged, speculative paged) reads False, every other slot True; the
    restart's ms to the first replayed token and the peak memory; the
    armed against the unarmed tick (ms, launches a tick), interleaved.
    (3) max_restarts=0 fails every open request with the cause."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor import (disarm_flight_recorder,
                                          get_histogram, hist_delta)
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.resilience import configure_faults
    from paddle_tpu_torch.serving import InferenceEngine

    requests = phase5_requests(cfg.vocab_size, seed=30)
    spec = f"serving_nan@step={NAN_RID}"
    cfg32 = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    p32 = _scaled_params(G, cfg32, dev)
    identity = {}
    for paged in (False, True):
        mode = "paged" if paged else "fixed"
        base = _outcomes(_submit_all(InferenceEngine(
            cfg32, p32, n_slots=8, paged=paged, seed=5), requests))
        s0 = {k: stat_get(k) for k in ("serving_watchdog_trips",
                                       "serving_watchdog_restarts")}
        configure_faults(spec)
        try:
            eng = InferenceEngine(cfg32, p32, n_slots=8, paged=paged,
                                  seed=5, watchdog=True,
                                  flight_dir=flight_dir)
            got = _outcomes(_submit_all(eng, requests))
            eng.shutdown()
        finally:
            configure_faults("")
        d = {k: stat_get(k) - v for k, v in s0.items()}
        if got[NAN_RID][1:] != ("watchdog", "WatchdogTripped") \
                or d["serving_watchdog_trips"] != 1 \
                or d["serving_watchdog_restarts"] != 1:
            raise AssertionError(f"{mode} watchdog run: request "
                                 f"{NAN_RID} {got[NAN_RID][1:]}, {d}")
        if any(o[1] != "length" for i, o in enumerate(got) if i != NAN_RID):
            raise AssertionError(f"{mode}: healthy streams ended "
                                 f"{[o[1] for o in got]}")
        equal, ties = _hold_identity(
            G, cfg32, p32, requests, [o[0] for o in base],
            [o[0] for o in got], dev, skip=(NAN_RID,))
        identity[mode] = {"streams_equal": equal + 2, "near_ties": ties,
                          "of": len(requests) - 1, **d}
    dumps = sorted(f for f in os.listdir(flight_dir)
                   if f.endswith("_serving_watchdog_restart.json"))
    for f in dumps:
        with open(os.path.join(flight_dir, f)) as fh:
            doc = json.load(fh)
        if doc["flight"]["reason"] != "serving_watchdog_restart" \
                or doc["flight"]["poisoned"] == []:
            raise AssertionError(f"flight dump {f} is off: {doc['flight']}")
    if len(dumps) != 2:
        raise AssertionError(f"want 2 watchdog dumps, found {dumps}")
    # the recorder stays armed once armed: disarm it, so the later legs'
    # spans cost what they cost without it
    disarm_flight_recorder()
    del p32
    torch.cuda.empty_cache()

    # (2) each decode path at full depth, bf16, one poisoned slot
    draft = G.gpt_truncate(cfg, params, 2)
    paths = {"fixed": dict(paged=False), "paged": dict(paged=True),
             "int8_paged": dict(paged=True, int8_weights=True),
             "spec_paged": dict(paged=True, draft=draft, spec_k=SPEC_K)}
    verdicts, launches = {}, {}
    for name, kw in paths.items():
        configure_faults(spec)
        _fresh_peak(dev)
        try:
            eng = InferenceEngine(cfg, params, n_slots=8, seed=5,
                                  watchdog=True, **kw)
            log = _record_verdicts(eng)
            _counts(mods)
            reqs = _submit_all(eng, requests)
            for r in reqs:
                _record_pushes(r)
            got = _outcomes(reqs)
            launches[name] = _read(mods)
            eng.shutdown()
        finally:
            configure_faults("")
        row = _verdict_row(log, reqs)
        bad = [o for i, o in enumerate(got) if i != NAN_RID
               and (o[1] != "length" or len(o[0]) != RES_NEW)]
        if got[NAN_RID][1] != "watchdog" or bad:
            raise AssertionError(f"{name}: {got[NAN_RID][1:]}, {bad}")
        pool = sum(t.numel() * t.element_size() for t in (
            (eng.cache.kb, eng.cache.vb) if eng.paged
            else (eng.cache.k, eng.cache.v)))
        verdicts[name] = {**row, "peak_mem_gib":
                          torch.cuda.max_memory_allocated(dev) / 2**30,
                          "kv_pool_gib": pool / 2**30}
        del eng, log
    want = {"fixed": "flash_attention_fwd",
            "paged": "paged_attention_decode",
            "int8_paged": "int8_matmul", "spec_paged": None}
    for name, kname in want.items():
        if kname is not None and launches[name].get(kname, 0) <= 0:
            raise AssertionError(f"{kname} never launched on {name}")

    # the armed against the unarmed tick, in turns; the unarmed runs' peak
    # memory beside the paged restart's
    tick = {"armed": [], "unarmed": []}
    unarmed_peak = []
    for armed in (False, True, True, False, False, True):
        _fresh_peak(dev)
        h0 = get_histogram("serving_decode_tick_ms").snapshot()
        eng = InferenceEngine(cfg, params, n_slots=8, paged=True, seed=5,
                              watchdog=True if armed else None)
        _outcomes(_submit_all(eng, requests))
        eng.shutdown()
        del eng
        d = hist_delta(h0, get_histogram("serving_decode_tick_ms")
                       .snapshot())
        tick["armed" if armed else "unarmed"].append(d["sum"] / d["count"])
        if not armed:
            unarmed_peak.append(torch.cuda.max_memory_allocated(dev) / 2**30)
    per_tick = {
        name: _launches_per_tick(lambda wd=wd: InferenceEngine(
            cfg, params, n_slots=8, paged=True, watchdog=wd),
            _greedy(requests))
        for name, wd in (("unarmed", None), ("armed", True))}

    # (3) the budget spent: every open request fails with the cause
    configure_faults("serving_nan@step=0")
    try:
        eng = InferenceEngine(cfg, params, n_slots=8, paged=True, seed=5,
                              watchdog={"max_restarts": 0},
                              flight_dir=flight_dir)
        ex = _outcomes(_submit_all(eng, requests[:4]))
        eng.shutdown()
    finally:
        configure_faults("")
        disarm_flight_recorder()
    if any(o[2] != "WatchdogTripped" for o in ex) or eng.alive \
            or not any(f.endswith("engine_abort_WatchdogTripped.json")
                       for f in os.listdir(flight_dir)):
        raise AssertionError(f"exhausted budget: {ex}")
    row = {"phase": "serving_watchdog", "model": "gpt_1p3b",
           "fault": spec, "identity_f32": {"layers": IDENTITY_LAYERS,
                                           **identity},
           "flight_dumps": dumps, "layers": cfg.n_layers,
           "verdicts": verdicts, "tick_ms": tick,
           "unarmed_paged_peak_mem_gib": unarmed_peak,
           "paged_restart_peak_over_unarmed_gib":
               verdicts["paged"]["peak_mem_gib"] - max(unarmed_peak),
           "armed_over_unarmed": float(np.mean(tick["armed"])
                                       / np.mean(tick["unarmed"])),
           "launches_per_tick": per_tick,
           "exhausted": [o[1:] for o in ex], "launches": launches,
           **stamp}
    emit(row)
    return row


def _holding_controller():
    """An OverloadController whose pressure stays inside its hysteresis
    band (budgets far above any wait, a tiny low-water mark): it holds
    whatever rung it is put on."""
    from paddle_tpu_torch.serving import OverloadController

    return OverloadController(queue_wait_budget_ms=1e9, tick_budget_ms=1e9,
                              low_water=1e-15)


def _chunk_spans(fn):
    """Run ``fn`` with tracing on; returns (its result, the ``chunk`` arg
    of every serving.prefill_chunk span)."""
    from paddle_tpu_torch import monitor

    writer = monitor.start_tracing()
    try:
        out = fn()
    finally:
        monitor.stop_tracing()
    chunks = [e["args"]["chunk"] for e in writer.events()
              if e["name"] == "serving.prefill_chunk"]
    writer.clear()
    return out, chunks


def overload_phase(dev, cfg, params, mods, stamp):
    """Phase 31: overload control at full depth, bf16, paged, with a
    2-layer draft at SPEC_K: a controller held at rung 0 gives the greedy
    tokens of overload=None; at rung 1 spec_proposed stops growing; at
    rung 2 a 1500-token prompt prefills in CHUNK_RUNG2-token chunks
    instead of CHUNK_RUNG0 (the serving.prefill_chunk spans' chunk arg).
    Prints the brownout gauges and the queue-wait and tick histograms'
    p50 and p99 over the phase."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor import (get_histogram, hist_delta,
                                          hist_quantile)
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    draft = G.gpt_truncate(cfg, params, 2)
    prompts = _greedy(phase5_requests(cfg.vocab_size, seed=31))
    names = ("serving_queue_wait_ms", "serving_decode_tick_ms")
    h0 = {n: get_histogram(n).snapshot() for n in names}
    s0 = {k: stat_get(k) for k in ("brownout_steps", "spec_proposed")}
    kw = dict(n_slots=8, paged=True, seed=5, draft=draft, spec_k=SPEC_K)
    base = _generate(InferenceEngine(cfg, params, **kw), prompts, RES_NEW)
    ctl = _holding_controller()
    eng = InferenceEngine(cfg, params, overload=ctl, **kw)
    try:
        _counts(mods)
        got = [r.result(timeout=600) for r in
               [eng.submit(p, max_new_tokens=RES_NEW) for p in prompts]]
        rung0_proposed = stat_get("spec_proposed") - s0["spec_proposed"]
        ctl.force_rung(1)
        p1 = stat_get("spec_proposed")
        [r.result(timeout=600) for r in
         [eng.submit(p, max_new_tokens=RES_NEW) for p in prompts[:4]]]
        rung1_growth = stat_get("spec_proposed") - p1
        long = prompts[-1]
        _, rung1_chunks = _chunk_spans(
            lambda: eng.generate(long, max_new_tokens=1))
        ctl.force_rung(2)
        _, rung2_chunks = _chunk_spans(
            lambda: eng.generate(long, max_new_tokens=1))
        # rungs 0-2 together: the speculative ticks attend in composed
        # PyTorch, rung 1's one-token ticks launch the paged kernel
        launches = _read(mods)
    finally:
        eng.shutdown()
    rung = stat_get("brownout_rung")
    d = {n: hist_delta(h0[n], get_histogram(n).snapshot()) for n in names}
    row = {"phase": "serving_overload", "mode": "paged",
           "model": "gpt_1p3b", "layers": cfg.n_layers, "draft_layers": 2,
           "spec_k": SPEC_K, "rung0_greedy_equal": got == base,
           "rung0_spec_proposed": rung0_proposed,
           "rung1_spec_proposed_growth": rung1_growth,
           "prompt_tokens": int(long.size),
           "rung1_chunks": len(rung1_chunks),
           "rung1_chunk_sizes": sorted(set(rung1_chunks)),
           "rung2_chunks": len(rung2_chunks),
           "rung2_chunk_sizes": sorted(set(rung2_chunks)),
           "brownout_rung": rung,
           "brownout_steps": stat_get("brownout_steps")
           - s0["brownout_steps"],
           "histograms": {n: {"count": d[n]["count"],
                              "p50_ms": hist_quantile(d[n], 0.5),
                              "p99_ms": hist_quantile(d[n], 0.99)}
                          for n in names},
           "launches": launches, **stamp}
    emit(row)
    if not row["rung0_greedy_equal"] or rung0_proposed <= 0 \
            or rung1_growth != 0 or rung != 2 \
            or max(rung1_chunks) != CHUNK_RUNG0 \
            or max(rung2_chunks) != CHUNK_RUNG2 \
            or sum(rung2_chunks) != long.size \
            or sum(rung1_chunks) != long.size \
            or launches["paged_attention_decode"] <= 0:
        raise AssertionError(f"overload run is off: {row}")
    return row


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _payload_bytes(kb, vb):
    return sum(t.numel() * t.element_size() for t in (kb, vb))


def kv_stream_phase(dev, cfg, params, mods, stamp):
    """Phase 32: KV streaming between two bf16 engines at full depth,
    paged with the prefix cache, on one card. A prefills a 1024-token
    prompt; export_kv_prefix from A and import_kv_prefix into B move its
    64 blocks; B's greedy stream equals A's second submission. Then a
    1500-token prompt streams in STREAM_CHUNK_BLOCKS-block chunks
    (export_kv_range / import_kv_chunk) while A prefills it, until done.
    Bytes, ms and GB/s of each export and import; B's hit rate and
    first-token ms against a cold submission."""
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    rng = np.random.default_rng(32)
    V = cfg.vocab_size
    p1 = rng.integers(0, V, 1024).astype(np.int32)
    p2 = rng.integers(0, V, 1500).astype(np.int32)
    cold = rng.integers(0, V, 1024).astype(np.int32)
    kw = dict(n_slots=8, paged=True, prefix_cache=True, seed=5)
    a = InferenceEngine(cfg, params, **kw)
    b = InferenceEngine(cfg, params, **kw)
    try:
        _counts(mods)
        a.warm_prefix(p1).result(timeout=600)
        exp, exp_ms = _timed(lambda: a.export_kv_prefix(p1, timeout=600))
        nbytes = _payload_bytes(exp["kb"], exp["vb"])
        m0 = (stat_get("prefix_matched_tokens"),
              stat_get("prefix_lookup_tokens"))
        cached, imp_ms = _timed(lambda: b.import_kv_prefix(
            p1, exp["kb"], exp["vb"], exp["matched_len"], timeout=600))
        rb = b.submit(p1, max_new_tokens=RES_NEW)
        got = rb.result(timeout=600)
        hit = ((stat_get("prefix_matched_tokens") - m0[0])
               / max(stat_get("prefix_lookup_tokens") - m0[1], 1))
        want = a.generate(p1, max_new_tokens=RES_NEW)
        rc = b.submit(cold, max_new_tokens=RES_NEW)
        rc.result(timeout=600)
        # the chunked stream while A prefills the 1500-token prompt
        warm = a.warm_prefix(p2)
        chunks, ack = [], 0
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            e, ems = _timed(lambda: a.export_kv_range(
                p2, start_block=ack // a.block_size,
                max_blocks=STREAM_CHUNK_BLOCKS, timeout=600))
            if e["n_blocks"] > 0:
                got_ack, ims = _timed(lambda: b.import_kv_chunk(
                    p2, e["kb"], e["vb"], e["start_block"],
                    e["covered_tokens"], timeout=600))
                nb = _payload_bytes(e["kb"], e["vb"])
                chunks.append({"start_block": e["start_block"],
                               "n_blocks": e["n_blocks"], "bytes": nb,
                               "done": e["done"], "export_ms": ems,
                               "import_ms": ims,
                               "export_gb_s": nb / ems / 1e6,
                               "import_gb_s": nb / ims / 1e6})
                if got_ack <= ack:
                    raise AssertionError(f"stream stalled at {ack}")
                ack = got_ack
            if e["done"] and ack >= e["matched_len"]:
                break
        warm.result(timeout=600)
        got2 = b.generate(p2, max_new_tokens=RES_NEW)
        want2 = a.generate(p2, max_new_tokens=RES_NEW)
        launches = _read(mods)
    finally:
        a.shutdown()
        b.shutdown()
    row = {"phase": "serving_kv_stream", "mode": "paged",
           "model": "gpt_1p3b", "layers": cfg.n_layers,
           "prefix_tokens": int(p1.size), "matched_len": exp["matched_len"],
           "dtype": exp["dtype"], "shape": exp["shape"],
           "export_bytes": nbytes, "export_ms": exp_ms,
           "export_gb_s": nbytes / exp_ms / 1e6, "import_ms": imp_ms,
           "import_gb_s": nbytes / imp_ms / 1e6, "imported_tokens": cached,
           "greedy_equal_to_source": got == want,
           "b_prefix_hit_rate": hit,
           "b_first_token_ms": (rb._t_first - rb._t_submit) * 1e3,
           "b_cold_first_token_ms": (rc._t_first - rc._t_submit) * 1e3,
           "stream_prompt_tokens": int(p2.size), "stream_ack": ack,
           "stream_chunks": chunks,
           "stream_mid_prefill_chunks": sum(not c["done"] for c in chunks),
           "stream_greedy_equal_to_source": got2 == want2,
           "launches": launches, **stamp}
    emit(row)
    if not row["greedy_equal_to_source"] or cached < p1.size - 1 \
            or exp["shape"][0] != 64 or ack != p2.size - 1 \
            or not row["stream_greedy_equal_to_source"] or hit <= 0 \
            or launches["paged_attention_decode"] <= 0:
        raise AssertionError(f"KV streaming run is off: {row}")
    return row


def _evacuate_run(G, cfg32, p32, requests, flight_dir):
    """A (replica 0) serves phase 5's mix with fixed slots; once its 8
    running streams have 2 tokens each it is evacuated, and its failover
    hook adopts every stream into B (replica 1). Returns (outcomes, B,
    adopted request ids)."""
    from paddle_tpu_torch.serving import InferenceEngine, ReplicaEvacuated

    a = InferenceEngine(cfg32, p32, n_slots=8, seed=5, replica_id=0)
    b = InferenceEngine(cfg32, p32, n_slots=8, seed=5, replica_id=1,
                        flight_dir=flight_dir)
    adopted = []

    def hook(req, err):
        if not isinstance(err, ReplicaEvacuated):
            return False
        b.adopt_request(req)
        adopted.append(req.rid)
        return True

    a.failover = hook
    reqs = _submit_all(a, requests)
    deadline = time.monotonic() + 600
    while sum(len(r.tokens) >= 2 for r in reqs) < 8:
        if time.monotonic() > deadline:
            raise AssertionError("streams never reached 2 tokens on A")
        time.sleep(0.001)
    a.evacuate()
    at = [len(r.tokens) for r in reqs]   # no more than A's next tick adds
    out = _outcomes(reqs)
    a.shutdown()
    return out, b, adopted, at


def failover_phase(dev, cfg, params, mods, stamp, flight_dir):
    """Phase 33: failover, crash and tracing. f32 at full width,
    IDENTITY_LAYERS layers: A is evacuated mid-decode and its failover
    hook adopts every stream into B, each token-identical to an
    undisturbed run (greedy and sampled); fail_at_tick(2) on B raises
    InjectedCrash, closes B, dumps engine_abort_InjectedCrash, and a later
    submit names the cause; with tracing on and mint_trace() on 8 paged
    requests the chrome trace holds one serving.decode_step a tick,
    serving.decode_tick events a request, serving.prefill_chunk spans,
    one serving.request_done and one "f" flow a request. bf16 at full
    depth: ms a tick with tracing on and off, in turns."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor import get_histogram, hist_delta
    from paddle_tpu_torch.resilience import InjectedCrash
    from paddle_tpu_torch.serving import InferenceEngine

    requests = phase5_requests(cfg.vocab_size, seed=33)
    prompts = _greedy(requests)
    cfg32 = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    p32 = _scaled_params(G, cfg32, dev)
    want = [o[0] for o in _outcomes(_submit_all(InferenceEngine(
        cfg32, p32, n_slots=8, seed=5), requests))]
    _counts(mods)
    got, b, adopted, at = _evacuate_run(G, cfg32, p32, requests, flight_dir)
    launches = _read(mods)
    if sorted(adopted) != list(range(len(requests))) \
            or any(o[1] != "length" for o in got):
        raise AssertionError(f"evacuation: adopted {adopted}, "
                             f"{[o[1] for o in got]}")
    equal, ties = _hold_identity(G, cfg32, p32, requests, want,
                                 [o[0] for o in got], dev)
    # the crash
    b.fail_at_tick(2)
    r = b.submit(prompts[0], max_new_tokens=RES_NEW)
    crash = _outcomes([r])[0]
    b._thread.join(60)
    try:
        b.submit(prompts[0], max_new_tokens=1)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    monitor.disarm_flight_recorder()
    dumps = [f for f in os.listdir(flight_dir)
             if f.endswith("engine_abort_InjectedCrash.json")]
    for f in dumps:
        with open(os.path.join(flight_dir, f)) as fh:
            json.load(fh)
    if crash[2] != InjectedCrash.__name__ or b.alive or not dumps \
            or refused is None or "InjectedCrash" not in refused:
        raise AssertionError(f"crash leg: {crash[1:]}, alive {b.alive}, "
                             f"dumps {dumps}, submit {refused}")
    # tracing, f32 paged: 8 traced requests
    eng = InferenceEngine(cfg32, p32, n_slots=8, paged=True, seed=5)
    h0 = get_histogram("serving_decode_tick_ms").snapshot()
    writer = monitor.start_tracing()
    try:
        reqs = [eng.submit(p, max_new_tokens=RES_NEW,
                           trace=monitor.mint_trace())
                for p in prompts]
        [q.result(timeout=600) for q in reqs]
    finally:
        monitor.stop_tracing()
        eng.shutdown()
    ticks = hist_delta(h0, get_histogram("serving_decode_tick_ms")
                       .snapshot())["count"]
    with tempfile.TemporaryDirectory() as d:
        path = writer.write(os.path.join(d, "serving_trace.json"))
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    writer.clear()
    ids = {q.trace.trace_id for q in reqs}
    per = {i: {} for i in ids}
    for e in events:
        tid = (e.get("args") or {}).get("trace", e.get("id"))
        if tid in per:
            key = e["name"] if e["name"] != "request" else "flow_" + e["ph"]
            per[tid][key] = per[tid].get(key, 0) + 1
    steps = sum(e["name"] == "serving.decode_step" for e in events)
    tr = {"decode_steps": steps, "decode_ticks_run": ticks,
          "per_request": sorted(
              (v.get("serving.decode_tick", 0),
               v.get("serving.prefill_chunk", 0),
               v.get("serving.request_done", 0), v.get("flow_f", 0))
              for v in per.values()),
          "events": len(events)}
    if steps != ticks or any(
            n_tick != RES_NEW - 1 or n_chunk < 1 or done != 1 or f != 1
            for n_tick, n_chunk, done, f in tr["per_request"]):
        raise AssertionError(f"trace is off: {tr}")
    del p32
    torch.cuda.empty_cache()
    # bf16 at full depth: ms a tick with tracing on and off, in turns
    tick = {"on": [], "off": []}
    for on in (False, True, True, False):
        h0 = get_histogram("serving_decode_tick_ms").snapshot()
        eng = InferenceEngine(cfg, params, n_slots=8, paged=True, seed=5)
        writer = monitor.start_tracing() if on else None
        try:
            [q.result(timeout=600) for q in
             [eng.submit(p, max_new_tokens=RES_NEW,
                         trace=monitor.mint_trace() if on else None)
              for p in prompts]]
        finally:
            if on:
                monitor.stop_tracing()
                writer.clear()
            eng.shutdown()
        d = hist_delta(h0, get_histogram("serving_decode_tick_ms")
                       .snapshot())
        tick["on" if on else "off"].append(d["sum"] / d["count"])
    row = {"phase": "serving_failover", "model": "gpt_1p3b",
           "identity_f32": {"layers": IDENTITY_LAYERS, "mode": "fixed",
                            "adopted": len(adopted),
                            "tokens_at_evacuation": at,
                            "streams_equal": equal + 2, "near_ties": ties,
                            "of": len(requests)},
           "crash": {"finish": crash[1], "error": crash[2],
                     "dumps": dumps, "submit_after": refused},
           "trace_f32_paged": tr, "tick_ms_bf16": tick,
           "tracing_on_over_off": float(np.mean(tick["on"])
                                        / np.mean(tick["off"])),
           "layers": cfg.n_layers, "launches": launches, **stamp}
    emit(row)
    if launches["flash_attention_fwd"] <= 0:
        raise AssertionError("flash_attention_fwd never launched in the "
                             "failover run")
    return row


# phases 34-36: the in-process serving orchestration
# --------------------------------------------------------------------------

# phases 34: bench.py's serving_chaos mix (20 requests of 12-72 tokens,
# Poisson at ~24 rps, one in five with a tight deadline) and its faults
CHAOS_N = 20
CHAOS_LENS = (12, 24, 40, 72)
CHAOS_RPS = 24.0
CHAOS_NEW = 16
CHAOS_TIGHT_S = 0.4
CHAOS_FAULTS = ("replica_crash@step=20:replica=0,"
                "slow_tick@step=8:secs=0.15:repeat=3:replica=1,"
                "conn_drop@step=3")
# phase 35: 16 requests on one shared 512-token head (8-token tails); the
# crash comes late enough that replica 0 has decoded, the first respawn
# fails; the scale-down victim's streams are long enough to outlive its
# drain timeout and migrate
LIFE_N = 16
LIFE_HEAD = 512
LIFE_NEW = 16
LIFE_MIGRATE_NEW = 256
LIFE_FAULTS = "replica_crash@step=24:replica=0,spawn_fail@restart=1"
# phase 36: the front end's shared system prompt
SYSTEM_PROMPT = ("You are a terse assistant. Answer every question in one "
                 "short line, without preamble, and never repeat the "
                 "question back to the user. ") * 2


class _ThreadLaunches:
    """Count a kernel module's launches by the thread that made them (an
    engine's scheduler thread is its replica), by wrapping the module's
    ``_launch`` for the duration of a ``with`` block. The module's own
    ``LAUNCHES`` counts as before."""

    def __init__(self, mod):
        self.mod = mod
        self.by = {}

    def __enter__(self):
        self._orig = self.mod._launch

        def counted(*args, **kw):
            out = self._orig(*args, **kw)
            key = threading.get_ident()
            self.by[key] = self.by.get(key, 0) + 1
            return out

        self.mod._launch = counted
        return self

    def __exit__(self, *exc):
        self.mod._launch = self._orig

    def of(self, engines):
        return [self.by.get(e._thread.ident, 0) for e in engines]


def _chaos_mix(V, seed=1301):
    """bench.py's serving_chaos mix: prompts, Poisson gaps, tight set."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, V, CHAOS_LENS[i % len(CHAOS_LENS)])
               .astype(np.int32) for i in range(CHAOS_N)]
    gaps = rng.exponential(1 / CHAOS_RPS, CHAOS_N)
    tight = {i for i in range(CHAOS_N) if i % 5 == 4}
    return prompts, gaps, tight


def _chaos_run(router, prompts, gaps, tight=(), new=CHAOS_NEW):
    """Submit ``prompts`` through ``router`` at ``gaps``, each consumed by
    its own thread; a consumer whose index claims a ``conn_drop`` fault
    abandons its stream after two tokens and cancels it (what the front
    end does on a client's EOF). Returns per request (tokens or None if
    abandoned or failed, finish reason, first-token ms)."""
    from paddle_tpu_torch.resilience import faults

    n = len(prompts)
    results, finishes, first = [None] * n, [None] * n, [None] * n
    sub_t = [0.0] * n

    def consume(i, req):
        dropped = faults.ENABLED[0] \
            and faults.FAULTS.take_conn(i + 1) is not None
        toks = []
        try:
            for k, tok in enumerate(req.stream(timeout=600)):
                if first[i] is None:
                    first[i] = (time.perf_counter() - sub_t[i]) * 1e3
                toks.append(tok)
                if dropped and k >= 1:
                    req.cancel()
                    try:
                        req.result(timeout=600)
                    except RuntimeError:
                        pass
                    break
            results[i] = None if dropped else toks
        except RuntimeError:
            results[i] = None
        finishes[i] = req.finish_reason

    threads = []
    for i, p in enumerate(prompts):
        sub_t[i] = time.perf_counter()
        req = router.submit(p, max_new_tokens=new,
                            deadline_s=CHAOS_TIGHT_S if i in tight else 600)
        th = threading.Thread(target=consume, args=(i, req))
        th.start()
        threads.append(th)
        time.sleep(gaps[i])
    for th in threads:
        th.join(timeout=900)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a chaos consumer never finished")
    return results, finishes, first


def _pcts(vals):
    vals = [v for v in vals if v is not None]
    if not vals:
        return {"p50_ms": None, "p99_ms": None, "n": 0}
    return {"p50_ms": float(np.percentile(vals, 50)),
            "p99_ms": float(np.percentile(vals, 99)), "n": len(vals)}


def router_chaos_phase(dev, cfg, params, mods, stamp):
    """Phase 34: bench.py's serving_chaos first leg on the port. Two paged
    prefix-caching replicas behind an EngineRouter share one
    OverloadController; CHAOS_N requests arrive Poisson at CHAOS_RPS, one
    in five with a CHAOS_TIGHT_S deadline, under CHAOS_FAULTS. f32 at full
    width, IDENTITY_LAYERS layers: every completed stream equals a
    fault-free engine's (or parts at a near-tie, TIE_REL), every request
    ends with a finish reason, router_failovers >= 1, first-token p50 and
    p99, serving_replicas_healthy before and after. bf16 at full depth:
    the same mix through the paged pair and through a fixed-slot
    int8_weights pair, the crash armed: rows 1, 2 and 9's launches (row 2
    on each paged replica) and each pair's tokens/s."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor import (get_histogram, hist_delta,
                                          hist_quantile)
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.resilience import configure_faults
    from paddle_tpu_torch.serving import (EngineRouter, InferenceEngine,
                                          OverloadController)

    pa = mods["paged_attention_decode"]
    prompts, gaps, tight = _chaos_mix(cfg.vocab_size)
    paged_kw = dict(n_slots=4, paged=True, block_size=16, n_blocks=65,
                    prefill_chunk=64, prefix_cache=True)

    def chaos(cfg_, params_, kw):
        """One chaos run of a replica pair built from ``kw``."""
        ctl = OverloadController(queue_wait_budget_ms=150.0,
                                 tick_budget_ms=120.0, step_up_after=2,
                                 step_down_after=6)
        s0 = {k: stat_get(k) for k in ("router_failovers",
                                       "serving_decode_ms",
                                       "serving_deadline_sheds")}
        h0 = get_histogram("serving_first_token_ms").snapshot()
        configure_faults(CHAOS_FAULTS)
        engines = [InferenceEngine(cfg_, params_, seed=0, overload=ctl,
                                   queue_size=4 * CHAOS_N, **kw)
                   for _ in range(2)]
        router = EngineRouter(engines)
        try:
            healthy0 = stat_get("serving_replicas_healthy")
            _counts(mods)
            with _ThreadLaunches(pa) as tl:
                t0 = time.perf_counter()
                res, fin, first = _chaos_run(router, prompts, gaps, tight)
                wall = time.perf_counter() - t0
            launches = _read(mods)
            healthy1 = stat_get("serving_replicas_healthy")
            alive = router.healthy_replicas()
        finally:
            configure_faults("")
            router.shutdown(drain=False, timeout=120)
        d = hist_delta(h0, get_histogram("serving_first_token_ms")
                       .snapshot())
        done = [i for i in range(CHAOS_N) if fin[i] in ("length", "eos")
                and res[i] is not None]
        toks = sum(len(r) for r in res if r is not None)
        decode_ms = stat_get("serving_decode_ms") - s0["serving_decode_ms"]
        row = {"layers": cfg_.n_layers, "dtype": str(cfg_.dtype),
               "finish_reasons": fin, "completed": len(done),
               "abandoned": sum(r is None and f == "cancelled"
                                for r, f in zip(res, fin)),
               "deadline": sum(f == "deadline" for f in fin),
               "silent": sum(f is None for f in fin),
               "router_failovers": stat_get("router_failovers")
               - s0["router_failovers"],
               "deadline_sheds": stat_get("serving_deadline_sheds")
               - s0["serving_deadline_sheds"],
               "replicas_healthy_before": healthy0,
               "replicas_healthy_after": healthy1,
               "healthy_replicas_at_end": alive,
               "first_token": _pcts(first),
               "first_token_hist": {"count": d["count"],
                                    "p50_ms": hist_quantile(d, 0.5),
                                    "p99_ms": hist_quantile(d, 0.99)},
               "wall_s": wall, "tokens": toks, "tok_s_wall": toks / wall,
               "decode_tokens": sum(max(len(r) - 1, 0)
                                    for r in res if r is not None),
               "decode_ms_total": decode_ms,
               "launches": launches,
               "paged_launches_by_replica": tl.of(engines)}
        # the decode ticks' summed ms over both replicas (phase 5's
        # definition, per replica-busy second)
        row["decode_tok_s"] = row["decode_tokens"] / max(decode_ms, 1) * 1e3
        if row["silent"] or row["router_failovers"] < 1 or alive != [1] \
                or healthy0 != 2 or healthy1 != 1 or not done:
            raise AssertionError(f"router chaos run is off: {row}")
        return row, res, done

    # f32 identity at full width
    cfg32 = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    p32 = _scaled_params(G, cfg32, dev)
    ref = InferenceEngine(cfg32, p32, seed=0, queue_size=4 * CHAOS_N,
                          **paged_kw)
    try:
        want = [ref.generate(p, max_new_tokens=CHAOS_NEW) for p in prompts]
    finally:
        ref.shutdown()
    f32, res, done = chaos(cfg32, p32, paged_kw)
    equal, ties = _streams_equal(G, cfg32, p32, [prompts[i] for i in done],
                                 [want[i] for i in done],
                                 [res[i] for i in done], dev)
    f32.update(identity=1.0, streams_equal=equal, near_ties=ties)
    del p32
    torch.cuda.empty_cache()
    # bf16 at full depth: the paged pair, then the fixed-slot int8 pair
    bf16 = {"paged": chaos(cfg, params, paged_kw)[0],
            "int8_fixed": chaos(cfg, params, dict(
                n_slots=4, paged=False, int8_weights=True))[0]}
    row = {"phase": "serving_router_chaos", "model": "gpt_1p3b",
           "requests": CHAOS_N, "prompt_lens": list(CHAOS_LENS),
           "rps": CHAOS_RPS, "new_tokens": CHAOS_NEW,
           "tight_deadline_s": CHAOS_TIGHT_S, "faults": CHAOS_FAULTS,
           "f32": f32, "bf16": bf16, **stamp}
    emit(row)
    pl = bf16["paged"]["launches"]
    il = bf16["int8_fixed"]["launches"]
    if pl["paged_attention_decode"] <= 0 \
            or min(bf16["paged"]["paged_launches_by_replica"]) <= 0 \
            or min(f32["paged_launches_by_replica"]) <= 0 \
            or il["flash_attention_fwd"] <= 0 or il["int8_matmul"] <= 0:
        raise AssertionError(f"router chaos launches are off: {row}")
    return row


def supervisor_phase(dev, mods, stamp):
    """Phase 35: bench.py's lifecycle leg on the port, f32 at full width
    and IDENTITY_LAYERS layers (every check is a token identity). Two
    paged prefix-caching replicas and a ReplicaSupervisor over their
    engine factory; LIFE_N requests on one LIFE_HEAD-token head arrive
    Poisson under LIFE_FAULTS: replica 0 crashes, the first respawn fails
    (spawn_fail), the second rejoins through the ladder, re-warms the
    hot head and serves; streams equal a fault-free engine's. The
    rejoined replica's first-token ms on a fresh tail against a cold
    engine's. A forced rung scales the set up to 3; back at rung 0 the
    least-loaded replica drains (a slow_tick fault on it keeps its stream
    open past the drain timeout), and its open stream migrates to a
    survivor, equal to an undisturbed run."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.resilience import configure_faults
    from paddle_tpu_torch.serving import (EngineRouter, InferenceEngine,
                                          ReplicaSupervisor)

    pa = mods["paged_attention_decode"]
    cfg32 = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    p32 = _scaled_params(G, cfg32, dev)
    V = cfg32.vocab_size
    rng = np.random.default_rng(35)
    head = rng.integers(0, V, LIFE_HEAD).astype(np.int32)
    tails = [np.concatenate([head, rng.integers(0, V, 8).astype(np.int32)])
             for _ in range(LIFE_N + 1)]
    gaps = rng.exponential(1 / CHAOS_RPS, LIFE_N)
    mig = [rng.integers(0, V, 32).astype(np.int32) for _ in range(5)]
    kw = dict(n_slots=4, paged=True, block_size=16, n_blocks=257,
              prefill_chunk=64, prefix_cache=True, seed=0, queue_size=64)
    ctl = _holding_controller()
    made = []

    def factory():
        eng = InferenceEngine(cfg32, p32, overload=ctl, **kw)
        made.append(eng)
        return eng

    ref = InferenceEngine(cfg32, p32, **kw)
    try:
        want = [ref.generate(t, max_new_tokens=LIFE_NEW)
                for t in tails[:LIFE_N]]
        want_mig = [ref.generate(p, max_new_tokens=LIFE_MIGRATE_NEW)
                    for p in mig[4:]]
    finally:
        ref.shutdown()
    s0 = {k: stat_get(k) for k in (
        "serving_replica_restarts", "serving_scale_events",
        "prefix_warm_tokens", "router_failovers")}
    configure_faults(LIFE_FAULTS)
    router = EngineRouter([factory(), factory()])
    sup = ReplicaSupervisor(
        router, factory, min_replicas=2, max_replicas=3, poll_s=0.05,
        backoff_s=0.1, quarantine_s=1.0, stable_s=1.0, scale_up_rung=1,
        scale_up_after=2, scale_down_after=6, scale_down_occupancy=0.9,
        scale_cooldown_s=0.5, drain_timeout_s=0.2)

    def wait(pred, what, timeout=300.0):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise AssertionError(f"supervisor never {what}: "
                                     f"{sup.snapshot()}")
            time.sleep(0.02)

    try:
        _counts(mods)
        with _ThreadLaunches(pa) as tl:
            res, fin, first = _chaos_run(router, tails[:LIFE_N], gaps,
                                         new=LIFE_NEW)
            wait(lambda: sup.snapshot()["rejoins"] >= 1 and all(
                r["state"] == "live"
                for r in sup.snapshot()["replicas"].values()), "rejoined")
            configure_faults("")
            rejoined = router.engine_for(0)
            warm_peek = rejoined.run_on_scheduler(
                lambda e: e._prefix.peek(head), timeout=600)
            probe = rejoined.submit(tails[LIFE_N], max_new_tokens=LIFE_NEW)
            probe_out = probe.result(timeout=600)
            warm_ms = (probe._t_first - probe._t_submit) * 1e3
            # scale up on a forced rung
            ctl.force_rung(1)
            wait(lambda: router.n_replicas == 3
                 and sup.snapshot()["scale_ups"] == 1, "scaled up")
            # open streams on every replica, the fewest on the newest;
            # back at rung 0 it is the least-loaded victim and drains, and
            # its ticks are stretched so that its stream outlasts the
            # drain timeout and migrates
            configure_faults("slow_tick@step=0:secs=0.02:repeat=100000:"
                             "replica=2")
            hogs = [router.engine_for(r).submit(p, max_new_tokens=
                                                LIFE_MIGRATE_NEW)
                    for r, p in ((0, mig[0]), (0, mig[1]), (1, mig[2]),
                                 (1, mig[3]))]
            moved = router.engine_for(2).submit(
                mig[4], max_new_tokens=LIFE_MIGRATE_NEW)
            fo_drain = stat_get("router_failovers")
            ctl.force_rung(0)
            wait(lambda: router.n_replicas == 2
                 and sup.snapshot()["scale_downs"] == 1, "scaled down")
            moved_out = moved.result(timeout=600)
            for h in hogs:
                h.result(timeout=600)
            configure_faults("")
        launches = _read(mods)
        migrated = stat_get("router_failovers") - fo_drain
        snap = sup.snapshot()
        by_replica = tl.of(made)
    finally:
        configure_faults("")
        router.shutdown(drain=False, timeout=120)
    cold = InferenceEngine(cfg32, p32, **kw)
    try:
        c = cold.submit(tails[LIFE_N], max_new_tokens=LIFE_NEW)
        cold_out = c.result(timeout=600)
        cold_ms = (c._t_first - c._t_submit) * 1e3
    finally:
        cold.shutdown()
    done = [i for i in range(LIFE_N) if fin[i] == "length"]
    equal, ties = _streams_equal(G, cfg32, p32, [tails[i] for i in done],
                                 [want[i] for i in done],
                                 [res[i] for i in done], dev)
    mig_equal, mig_ties = _streams_equal(G, cfg32, p32, [mig[4]],
                                         want_mig, [moved_out], dev)
    probe_equal, _ = _streams_equal(G, cfg32, p32, [tails[LIFE_N]],
                                    [cold_out], [probe_out], dev)
    row = {"phase": "serving_supervisor", "model": "gpt_1p3b",
           "layers": IDENTITY_LAYERS, "dtype": "float32",
           "requests": LIFE_N, "head_tokens": LIFE_HEAD,
           "faults": LIFE_FAULTS, "finish_reasons": fin,
           "completed": len(done), "streams_equal": equal,
           "near_ties": ties, "identity": 1.0,
           "first_token": _pcts(first),
           "restarts": stat_get("serving_replica_restarts")
           - s0["serving_replica_restarts"],
           "spawns": snap["spawns"], "rejoins": snap["rejoins"],
           "scale_events": stat_get("serving_scale_events")
           - s0["serving_scale_events"],
           "scale_ups": snap["scale_ups"],
           "scale_downs": snap["scale_downs"],
           "replicas_final": len(snap["replicas"]),
           "warm_tokens": stat_get("prefix_warm_tokens")
           - s0["prefix_warm_tokens"],
           "rejoined_tree_holds_head": warm_peek,
           "first_token_rejoined_ms": warm_ms,
           "first_token_cold_ms": cold_ms,
           "rejoined_vs_cold": warm_ms / cold_ms,
           "probe_equal_to_cold": probe_equal == 1,
           "migrated_streams": migrated,
           "migrated_equal": mig_equal, "migrated_near_ties": mig_ties,
           "migrated_to": getattr(moved, "_replica", 2),
           "launches": launches, "paged_launches_by_replica": by_replica,
           **stamp}
    emit(row)
    # spawns: the failed respawn, the rejoin, the scale-up
    if len(done) != LIFE_N or snap["rejoins"] != 1 or snap["spawns"] != 3 \
            or row["restarts"] != 3 or snap["scale_ups"] != 1 \
            or snap["scale_downs"] != 1 or migrated < 1 \
            or row["migrated_to"] == 2 or warm_peek < LIFE_HEAD \
            or row["warm_tokens"] < LIFE_HEAD or len(made) != 4 \
            or min(by_replica) <= 0:
        raise AssertionError(f"supervisor run is off: {row}")
    return row


def prom_families(text):
    """{metric family: type} of a Prometheus text exposition; every
    sample line must parse."""
    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line and not line.startswith("#"):
            m = re.fullmatch(r'([a-zA-Z_:][a-zA-Z0-9_:]*)'
                             r'(\{le="[^"]+"\})? (\S+)', line)
            if m is None:
                raise AssertionError(f"/metrics line does not parse: "
                                     f"{line!r}")
            float(m.group(3))
    return types


def frontend_phase(dev, mods, stamp):
    """Phase 36: the HTTP front end on 127.0.0.1 (an ephemeral port) over
    an EngineRouter of two bf16 paged prefix-caching replicas at full
    gpt_1p3b width and depth, with the byte tokenizer (the model's
    vocabulary is the tokenizer's; block matrices x4 so that greedy text
    varies): /v1/completions as JSON and SSE, whose
    greedy text equals the same prompt's text engine-direct on the other
    (cold) replica; /v1/chat/completions on a shared system prompt (prefix
    hit rate > 0); /v1/models; /metrics parses as Prometheus text and
    holds the five engine histograms and the frontend_* series; a 429
    with Retry-After from an exhausted bucket; a bounded regex
    response_format that ends "stop". First-token ms over HTTP (to the
    first SSE piece) beside engine-direct."""
    import http.client

    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import (ByteTokenizer, EngineRouter,
                                          InferenceEngine, ServingFrontend,
                                          Tenant)

    pa = mods["paged_attention_decode"]
    tok = ByteTokenizer()
    cfg = G.gpt_1p3b(vocab_size=tok.vocab_size)
    params = _scaled_params(G, cfg, dev)
    engines = [InferenceEngine(cfg, params, n_slots=8, paged=True,
                               prefix_cache=True, seed=5, tokenizer=tok)
               for _ in range(2)]
    router = EngineRouter(engines)
    fe = ServingFrontend(router, tenants=[
        Tenant("gold-co", "sk-gold", rate=1000, burst=1000, lane="gold"),
        Tenant("tiny-co", "sk-tiny", rate=0.01, burst=1, lane="bronze")])

    def call(method, path, body=None, key="sk-gold", stream=False):
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=600)
        try:
            t0 = time.perf_counter()
            conn.request(method, path,
                         json.dumps(body) if body is not None else None,
                         {"Authorization": f"Bearer {key}"})
            resp = conn.getresponse()
            if not stream:
                return resp.status, dict(resp.getheaders()), resp.read()
            first_ms, chunks = None, []
            while True:
                line = resp.fp.readline()
                if not line:
                    break
                if line.startswith(b"data: "):
                    if first_ms is None:
                        first_ms = (time.perf_counter() - t0) * 1e3
                    chunks.append(line[len(b"data: "):].strip())
            return resp.status, first_ms, chunks
        finally:
            conn.close()

    def direct(replica, prompt, new):
        """Greedy text of ``prompt`` on one replica, engine-direct, and
        its first-token ms."""
        req = router.engine_for(replica).submit(
            tok.encode(prompt), max_new_tokens=new, eos_id=tok.eos_id)
        text = req.text(timeout=600)
        return text, (req._t_first - req._t_submit) * 1e3

    out = {}
    try:
        fe.start()
        _counts(mods)
        with _ThreadLaunches(pa) as tl:
            # JSON: routed to replica 0 (idle tie); engine-direct on the
            # cold replica 1, each alone
            a = "The quick brown fox jumps over the lazy dog. Then"
            st, _, data = call("POST", "/v1/completions",
                               {"prompt": a, "max_tokens": 16})
            js = json.loads(data)
            if st != 200:
                raise AssertionError(f"/v1/completions {st}: {js}")
            out["json_text"] = js["choices"][0]["text"]
            out["json_usage"] = js["usage"]
            out["json_direct_text"], _ = direct(1, a, 16)
            # SSE: a second prompt, HTTP first (replica 0: idle tie, no
            # affinity), then engine-direct on replica 1
            b = "Once upon a time, in a land far away, there lived"
            st, http_first, chunks = call(
                "POST", "/v1/completions",
                {"prompt": b, "max_tokens": 16, "stream": True},
                stream=True)
            if st != 200 or chunks[-1] != b"[DONE]":
                raise AssertionError(f"SSE {st}: {chunks[-3:]}")
            events = [json.loads(c) for c in chunks[:-1]]
            out["sse_text"] = "".join(e["choices"][0]["text"]
                                      for e in events)
            out["sse_finish"] = events[-1]["choices"][0]["finish_reason"]
            out["sse_direct_text"], direct_first = direct(1, b, 16)
            out["first_token_http_ms"] = http_first
            out["first_token_direct_ms"] = direct_first
            # chat on a shared system prompt
            m0 = (stat_get("prefix_matched_tokens"),
                  stat_get("prefix_lookup_tokens"))
            chat = []
            for q in ("What is two plus two?", "Name a colour.",
                      "Say hello."):
                st, _, data = call("POST", "/v1/chat/completions", {
                    "messages": [{"role": "system",
                                  "content": SYSTEM_PROMPT},
                                 {"role": "user", "content": q}],
                    "max_tokens": 8})
                if st != 200:
                    raise AssertionError(f"chat {st}: {data[:200]}")
                chat.append(json.loads(data)["choices"][0])
            out["chat_finish_reasons"] = [c["finish_reason"] for c in chat]
            out["chat_prefix_hit_rate"] = (
                (stat_get("prefix_matched_tokens") - m0[0])
                / max(stat_get("prefix_lookup_tokens") - m0[1], 1))
            # a bounded regex
            st, _, data = call("POST", "/v1/completions", {
                "prompt": "Is it so? Answer: ", "max_tokens": TEXT_NEW,
                "response_format": {"type": "regex", "regex": TEXT_REGEX}})
            rc = json.loads(data)["choices"][0]
            out["regex_text"], out["regex_finish"] = rc["text"], \
                rc["finish_reason"]
        launches = _read(mods)
        by_replica = tl.of(engines)
        st, _, data = call("GET", "/v1/models")
        out["models"] = json.loads(data)["data"][0]["id"] \
            if st == 200 else st
        codes = [call("POST", "/v1/completions",
                      {"prompt": "x", "max_tokens": 1}, key="sk-tiny")
                 for _ in range(2)]
        out["tiny_statuses"] = [c[0] for c in codes]
        out["retry_after"] = codes[-1][1].get("Retry-After")
        st, headers, data = call("GET", "/metrics")
        text = data.decode()
        fams = prom_families(text)
        st_r, _, data_r = call("GET", "/readyz")
        out["readyz"] = st_r
        out["readyz_replicas"] = sorted(json.loads(data_r)["checks"]
                                        ["replicas"])
    finally:
        fe.close()
        router.shutdown(drain=False, timeout=120)
        del params
        torch.cuda.empty_cache()
    hists = ("serving_first_token_ms", "serving_per_token_ms",
             "serving_queue_wait_ms", "serving_decode_tick_ms",
             "serving_prefill_chunk_ms")
    frontend = sorted(f for f in fams if f.startswith("paddle_tpu_frontend_"))
    row = {"phase": "serving_frontend", "model": "gpt_1p3b",
           "layers": cfg.n_layers, "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype), **out,
           "metrics_status": st,
           "metrics_content_type": headers.get("Content-Type"),
           "metrics_families": len(fams),
           "metrics_histograms": [h for h in hists
                                  if fams.get(f"paddle_tpu_{h}")
                                  == "histogram"],
           "metrics_frontend_series": frontend,
           "launches": launches, "paged_launches_by_replica": by_replica,
           **stamp}
    emit(row)
    if out["json_text"] != out["json_direct_text"] \
            or out["sse_text"] != out["sse_direct_text"] \
            or out["sse_finish"] not in ("length", "eos") \
            or out["chat_prefix_hit_rate"] <= 0 \
            or out["regex_finish"] != "stop" \
            or not re.fullmatch(TEXT_REGEX, out["regex_text"]) \
            or out["tiny_statuses"] != [200, 429] \
            or not out["retry_after"] or int(out["retry_after"]) < 1 \
            or st != 200 or len(row["metrics_histograms"]) != 5 \
            or len(frontend) < 5 or out["readyz"] != 200 \
            or out["models"] != fe.model_id or min(by_replica) <= 0:
        raise AssertionError(f"front end run is off: {row}")
    return row


# --------------------------------------------------------------------------
# phases 37-38: Paddle vision training (BASELINE configs 1 and 2)
# --------------------------------------------------------------------------

# bench.py's bench_lenet and bench_resnet50 on the card: batch, image
# side, steps
LENET_BATCH = 256
RESNET_BATCH = 256
RESNET_SIDE = 224
VISION_STEPS = 6
# phase 37: LeNet's first loss on the card against the port's CPU run of
# the same weights and batch, relative. f32 throughout (cuDNN with TF32
# off, cuBLAS f32); only summation orders and cuDNN's choice of algorithm
# differ
LENET_FIRST_LOSS_REL = 1e-5
# phase 38's f32 check, ResNet-50 at batch 2 on the card against the CPU
# port with the same weights: the first loss relative, and bn1's running
# statistics after one step as max |Δ| / max |CPU| (one conv's output and
# its moments, summed in another order). conv1's and fc's gradients are
# held to the CPU's f64 run of the same model: at batch 2 a random-init
# ResNet-50's backward is ill-conditioned (the batch norms' backward
# subtracts projections that nearly cancel), so the CPU's own f32
# gradient of conv1 sits 2.5e-2 of its largest value from the f64 one
# (fc's 3.3e-5; measured on the CPU). The card must land within
# "grad_vs_f64" times the CPU f32 run's distance from f64: two f32 runs
# summing in other orders land at comparable distances, TF32's 10-bit
# operands far outside
RESNET_CHECK_TOL = {"loss": 1e-5, "grad_vs_f64": 3.0, "stats": 1e-5}


# every hand-written kernel's launch counter: (the kernels line's name,
# the module's key in the phases' ``mods``, its counter)
_KERNEL_COUNTERS = (
    ("flash_attention_fwd", "fa", "LAUNCHES"),
    ("paged_attention_decode", "pa", "LAUNCHES"),
    ("flash_attention_bwd", "fa", "BWD_LAUNCHES"),
    ("fused_ln_mlp_fwd", "fk", "FWD_LAUNCHES"),
    ("fused_ln_mlp_bwd", "fk", "BWD_LAUNCHES"),
    ("fused_ln_mlp_bwd_dw2", "fk", "DW2_LAUNCHES"),
    ("fused_adamw", "fo", "ADAMW_LAUNCHES"),
    ("fused_lamb", "fo", "LAMB_LAUNCHES"),
    ("int8_matmul", "im", "LAUNCHES"), ("fp8_matmul", "fm", "LAUNCHES"),
    ("moe_dispatch_gather", "md", "LAUNCHES"),
    ("fused_add_ln_fwd", "fk", "ADDLN_FWD_LAUNCHES"),
    ("fused_add_ln_bwd", "fk", "ADDLN_BWD_LAUNCHES"))


def _vision_counts(mods):
    """Every hand-written kernel's launch count (the vision path should
    launch none of them)."""
    return {n: getattr(mods[m], c) for n, m, c in _KERNEL_COUNTERS}


def _reset_vision_counts(mods):
    for _, m, c in _KERNEL_COUNTERS:
        setattr(mods[m], c, 0)


def _eager_steps(step, steps, dev, mods):
    """``steps`` eager steps of ``step`` (which returns the loss as a
    float, the host read that syncs it): losses, host ms a step, CUDA
    event ms a step, peak memory (and its rise over what earlier phases
    still hold when the run starts) and the kernels' launches (counts
    set to 0 just before the run)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    losses, host_ms, dev_ms = [], [], []
    _reset_vision_counts(mods)
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses.append(step())
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
    return {"losses": losses, "step_ms": host_ms, "event_ms": dev_ms,
            "step_ms_median_last3": float(np.median(host_ms[-3:])),
            "event_ms_median_last3": float(np.median(dev_ms[-3:])),
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "peak_over_start_gib": (torch.cuda.max_memory_allocated(dev)
                                    - base) / 2**30,
            "launches": _vision_counts(mods)}


def _profiled_step(step, host_ms, top=8):
    """One more step under torch.profiler: the summed device time of its
    kernels and copies, the device's idle share against ``host_ms`` (the
    unprofiled step), the device items launched and the ``top`` largest
    by device time."""
    from paddle_tpu_torch.tools.profile_decode import _device_us

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(((_device_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and _device_us(e) > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {"profiled_device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
            "profiled_launches": sum(r[2] for r in rows),
            "top_device_items": [{"name": k[:80], "ms": us / 1e3,
                                  "calls": c}
                                 for us, k, c in rows[:top]]}


def lenet_phase(dev, mods, stamp):
    """Phase 37: bench_lenet's user code on the card (LeNet, Adam 1e-3,
    f32, batch 256 of 1×28×28, seed 0) for VISION_STEPS eager steps; the
    first loss against the port's CPU run of the same weights and
    batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet

    paddle.set_device("gpu")
    paddle.seed(0)
    model = LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
    rng = np.random.default_rng(0)
    images_np = rng.normal(size=(LENET_BATCH, 1, 28, 28)).astype("float32")
    labels_np = rng.integers(0, 10, (LENET_BATCH,)).astype("int64")
    images, labels = paddle.to_tensor(images_np), paddle.to_tensor(labels_np)
    state = {k: v.numpy() for k, v in model.state_dict().items()}

    def step():
        loss = paddle.nn.functional.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    run = _eager_steps(step, VISION_STEPS, dev, mods)
    paddle.set_device("cpu")
    try:
        cpu = LeNet()
        cpu.set_state_dict(state)
        loss_cpu = float(paddle.nn.functional.cross_entropy(
            cpu(paddle.to_tensor(images_np)), paddle.to_tensor(labels_np)))
    finally:
        paddle.set_device("gpu")
    rel = abs(run["losses"][0] - loss_cpu) / abs(loss_cpu)
    ok = {"losses_finite": all(map(math.isfinite, run["losses"])),
          "first_loss_vs_cpu": rel <= LENET_FIRST_LOSS_REL}
    row = {"phase": "train_paddle_lenet", "model": "LeNet",
           "config": "BASELINE config 1 (bench.py bench_lenet)",
           "batch": [LENET_BATCH, 1, 28, 28], "dtype": "float32",
           "optimizer": "Adam(lr=1e-3)", "steps": VISION_STEPS, **run,
           "samples_per_s": LENET_BATCH / run["step_ms_median_last3"] * 1e3,
           "first_loss_cpu": loss_cpu, "first_loss_rel_to_cpu": rel,
           "tol_first_loss_rel": LENET_FIRST_LOSS_REL, "checks": ok,
           "ok": all(ok.values()), **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"LeNet phase failed: {ok}")
    return row


def _bn_stats(model):
    return {k: b._data.detach().clone() for k, b in model.named_buffers()}


def resnet50_phase(dev, mods, stamp):
    """Phase 38: bench_resnet50's user code on the card at full size
    (resnet50(num_classes=1000), amp.decorate O2 bf16, the loss under
    auto_cast O2, Momentum 0.1 / 0.9, batch 256 of 3×224×224, seed 0)
    for VISION_STEPS eager steps, then one step under torch.profiler."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50

    paddle.set_device("gpu")
    paddle.seed(0)
    model = paddle.amp.decorate(resnet50(num_classes=1000), level="O2",
                                dtype="bfloat16")
    opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
    rng = np.random.default_rng(0)
    images = paddle.to_tensor(rng.normal(
        size=(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE)).astype("float32"))
    labels = paddle.to_tensor(rng.integers(0, 1000, (RESNET_BATCH,)).astype(
        "int64"))
    before = _bn_stats(model)

    def step():
        with paddle.amp.auto_cast(enable=True, level="O2"):
            out = model(images)
        loss = paddle.nn.functional.cross_entropy(out, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss)

    run = _eager_steps(step, VISION_STEPS, dev, mods)
    after = _bn_stats(model)
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    prof = _profiled_step(step, run["step_ms_median_last3"])
    dtypes = {str(p.dtype).split(".")[-1] for p in model.parameters()}
    ok = {"losses_finite": all(map(math.isfinite, run["losses"])),
          "bn_stats_moved": moved == len(before) == 106,
          "bf16_and_f32_params": dtypes == {"bfloat16", "float32"}}
    row = {"phase": "train_paddle_resnet50_o2", "model": "resnet50",
           "config": "BASELINE config 2 (bench.py bench_resnet50)",
           "batch": [RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE],
           "num_classes": 1000, "amp": "O2 bfloat16 (norms f32)",
           "optimizer": "Momentum(lr=0.1, momentum=0.9)",
           "params": sum(p.size for p in model.parameters()),
           "steps": VISION_STEPS, **run,
           "samples_per_s": RESNET_BATCH / run["step_ms_median_last3"] * 1e3,
           "bn_buffers_moved": moved, **prof, "checks": ok,
           "ok": all(ok.values()), **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"ResNet-50 phase failed: {ok}")
    del model, opt, images, labels, before, after
    gc.collect()
    torch.cuda.empty_cache()
    return row


def resnet50_check_phase(dev, stamp, batch=2):
    """Phase 38's f32 check: resnet50 in f32 at ``batch`` × 3×224×224,
    one Momentum step on the card against the CPU port with the same
    weights (and the CPU in f64 as the gradients' yardstick): the first
    loss, conv1's and fc's gradients and bn1's running statistics after
    the step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50

    rng = np.random.default_rng(38)
    images = rng.normal(size=(batch, 3, RESNET_SIDE, RESNET_SIDE)).astype(
        "float32")
    labels = rng.integers(0, 1000, (batch,)).astype("int64")
    paddle.set_device("cpu")
    try:
        paddle.seed(38)
        state = {k: v.numpy() for k, v in resnet50().state_dict().items()}
        out = {}
        for run, where, dt in (("cpu", "cpu", "float32"),
                               ("cpu_f64", "cpu", "float64"),
                               ("card", "gpu", "float32")):
            paddle.set_device(where)
            model = resnet50()
            model.set_state_dict(state)
            model.to(dtype=dt)
            opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                            parameters=model.parameters())
            t0 = time.perf_counter()
            loss = paddle.nn.functional.cross_entropy(
                model(paddle.to_tensor(images, dtype=dt)),
                paddle.to_tensor(labels))
            loss.backward()
            grads = {n: getattr(model, n).weight.grad._data.cpu()
                     for n in ("conv1", "fc")}
            opt.step()
            stats = {k: model.bn1._buffers[k]._data.cpu()
                     for k in ("_mean", "_variance")}
            out[run] = (float(loss), grads, stats,
                        time.perf_counter() - t0)
            del model, opt
    finally:
        paddle.set_device("gpu")
    (l_cpu, g_cpu, s_cpu, t_cpu), (_, g64, _, t64), (
        l_card, g_card, s_card, t_card) = (out["cpu"], out["cpu_f64"],
                                           out["card"])
    err = {"loss": abs(l_card - l_cpu) / abs(l_cpu),
           "grad": {n: _rel(g_card[n], g) for n, g in g_cpu.items()},
           "grad_card_vs_f64": {n: _rel(g_card[n], g)
                                for n, g in g64.items()},
           "grad_cpu_vs_f64": {n: _rel(g_cpu[n], g) for n, g in g64.items()},
           "stats": {k: _rel(s_card[k], s) for k, s in s_cpu.items()}}
    ok = {"loss": err["loss"] <= RESNET_CHECK_TOL["loss"],
          "grad": all(err["grad_card_vs_f64"][n]
                      <= RESNET_CHECK_TOL["grad_vs_f64"]
                      * err["grad_cpu_vs_f64"][n] for n in g64),
          "stats": max(err["stats"].values()) <= RESNET_CHECK_TOL["stats"]}
    row = {"phase": "paddle_resnet50_card_vs_cpu", "model": "resnet50",
           "batch": [batch, 3, RESNET_SIDE, RESNET_SIDE], "dtype": "float32",
           "loss_card": l_card, "loss_cpu": l_cpu, "err": err,
           "tol": RESNET_CHECK_TOL, "checks": ok, "card_s": t_card,
           "cpu_s": t_cpu, "cpu_f64_s": t64, "ok": all(ok.values()),
           **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"ResNet-50 card and CPU disagree: {row}")
    return row


# --------------------------------------------------------------------------
# phases 41-42: Paddle's training entry points (paddle.Model, jit.TrainStep)
# --------------------------------------------------------------------------

# phase 41: MNIST's shape (60,000 training and 10,000 test images of
# 1x28x28, seeded), K replays for the "device" rate, the gates' steps
MNIST_TRAIN, MNIST_TEST = 60000, 10000
MODEL_K = 50
MODEL_GATE_STEPS, MODEL_SCHED_STEPS = 5, 10
# phase 41's gates: params of the captured step against the uncaptured
# one and against FLAGS_fused_optimizer=0, as max |Δ| over every param /
# max |p| over every param. The same Adam in another rounding order (the
# fused kernel's eager form against the per-parameter update) moves the
# params by 1.4e-7 of the largest after 5 steps at batch 256 on the CPU
# (one element of fc.0's weight, whose gradient is near 0, by 1.0e-6 of
# that leaf's largest: each leaf's own ratio is printed beside)
MODEL_PARAM_REL = 1e-6
# phase 42: ResNet-50's warm-up calls, per-call steps, K replays, and the
# first 3 losses of the captured step against the uncaptured one,
# relative (bf16 activations; the same kernels in the same order)
RESNET_WARM, RESNET_CALLS, RESNET_K = 3, 15, 10
RESNET_STEP_LOSS_REL = 1e-3


def _param_rel(a, b):
    """(max |Δ| over every param / max |b| over every param, each leaf's
    own max |Δ| / max |b|) of two {name: tensor} state dicts."""
    d = {k: (a[k].float() - b[k].float()).abs().max().item() for k in a}
    m = {k: b[k].float().abs().max().item() for k in b}
    return (max(d.values()) / max(max(m.values()), 1e-30),
            {k: d[k] / max(m[k], 1e-30) for k in d})


def _lenet_trainer(paddle, state, fused, capture, sched=False):
    """A LeNet from ``state`` under Adam (1e-3, or phase 41's warm-up +
    cosine schedule with a global-norm clip) and its TrainStep."""
    from paddle_tpu_torch.vision.models import LeNet

    paddle.set_flags({"FLAGS_fused_optimizer": fused})
    net = LeNet()
    net.set_state_dict(state)
    lr = (paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(1e-3, T_max=20),
        warmup_steps=5, start_lr=0.0, end_lr=1e-3) if sched else 1e-3)
    opt = paddle.optimizer.Adam(
        lr, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if sched else None)
    step = paddle.jit.TrainStep(
        net, lambda run, x, y: paddle.nn.functional.cross_entropy(run(x), y),
        opt, capture=capture)
    return net, step, lr


def _lenet_gate_run(paddle, state, batches, fused, capture, sched=False):
    net, step, lr = _lenet_trainer(paddle, state, fused, capture, sched)
    losses = []
    for x, y in batches:
        losses.append(step(x, y))
        if sched:
            lr.step()
    losses = [float(v) for v in losses]
    return ({k: v._data.detach().clone() for k, v in net.state_dict().items()},
            losses, step.captures)


def lenet_model_phase(dev, mods, stamp, eager_ms):
    """Phase 41: BASELINE config 1 as Paddle users write it: LeNet
    through paddle.Model (f32, batch 256, Adam 1e-3, FLAGS_fused_optimizer=1,
    FLAGS_fast_step=1) fitted one epoch over a DataLoader of a
    TensorDataset of MNIST's shape (shuffle, the last batch 96 rows: a
    second capture), then evaluate, predict and save -> load into a fresh
    Model (predictions bit-equal). Timed: fit's samples/s with the loader,
    the captured step's host ms a call and ms a step, "device" samples/s
    over MODEL_K replays with one host read. Gated: every loss finite,
    row 7 launched, 2 captures, the captured step against the uncaptured
    one and against FLAGS_fused_optimizer=0 (5 steps), and a warm-up +
    cosine schedule with a global-norm clip captured against uncaptured
    (10 steps)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet

    fo = mods["fo"]
    paddle.set_device("gpu")
    old = paddle.get_flags(["FLAGS_fused_optimizer", "FLAGS_fast_step"])
    paddle.set_flags({"FLAGS_fused_optimizer": 1, "FLAGS_fast_step": 1})
    old_det = torch.backends.cudnn.deterministic
    t_phase = time.perf_counter()
    try:
        rng = np.random.default_rng(41)
        data = {}
        for split, n in (("train", MNIST_TRAIN), ("test", MNIST_TEST)):
            x = rng.normal(size=(n, 1, 28, 28)).astype("float32")
            y = rng.integers(0, 10, (n,)).astype("int64")
            data[split] = paddle.io.TensorDataset(
                [paddle.to_tensor(x, place="cpu"),
                 paddle.to_tensor(y, place="cpu")])
        paddle.seed(0)
        net = LeNet()
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(1e-3,
                                            parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        raws = []
        train_batch = model.train_batch

        def recording(*a, **k):
            out = train_batch(*a, **k)
            raws.append(out[0])
            return out

        model.train_batch = recording
        _fresh_peak(dev)
        base = torch.cuda.memory_allocated(dev)
        np.random.seed(41)
        _reset_vision_counts(mods)
        t0 = time.perf_counter()
        model.fit(data["train"], batch_size=LENET_BATCH, epochs=1,
                  shuffle=True, drop_last=False, verbose=0, log_freq=50)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _vision_counts(mods)
        fit_losses = [float(r) for r in raws]
        st = model._train_step
        captures_fit = st.captures
        t0 = time.perf_counter()
        ev = model.evaluate(data["test"], batch_size=LENET_BATCH, verbose=0)
        eval_s = time.perf_counter() - t0
        preds = model.predict(data["test"], batch_size=LENET_BATCH,
                              stack_outputs=True)[0]
        with tempfile.TemporaryDirectory() as tmp:
            model.save(os.path.join(tmp, "lenet"))
            fresh = paddle.Model(LeNet())
            fresh.prepare(paddle.optimizer.Adam(
                1e-3, parameters=fresh.parameters()),
                paddle.nn.CrossEntropyLoss())
            fresh.load(os.path.join(tmp, "lenet"))
            again = fresh.predict(data["test"], batch_size=LENET_BATCH,
                                  stack_outputs=True)[0]
        # the captured step itself, on one staged batch
        x = paddle.to_tensor(data["train"].tensors[0]._data[:LENET_BATCH]
                             .numpy())
        y = paddle.to_tensor(data["train"].tensors[1]._data[:LENET_BATCH]
                             .numpy())
        host_ms, step_ms, timed = [], [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = st(x, y)
            t1 = time.perf_counter()
            timed.append(float(loss))
            host_ms.append((t1 - t0) * 1e3)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = st.steps(MODEL_K, x, y)
        timed.append(float(last))
        k_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        # the gates: the same weights and batches through three steps
        torch.backends.cudnn.deterministic = True
        batches = [(x, y)] + [
            (paddle.to_tensor(data["train"].tensors[0]._data[i:i + LENET_BATCH]
                              .numpy()),
             paddle.to_tensor(data["train"].tensors[1]._data[i:i + LENET_BATCH]
                              .numpy()))
            for i in range(LENET_BATCH, LENET_BATCH * MODEL_SCHED_STEPS,
                           LENET_BATCH)]
        five = batches[:MODEL_GATE_STEPS]
        n0 = fo.ADAMW_LAUNCHES
        cap, cap_l, cap_n = _lenet_gate_run(paddle, state, five, 1, True)
        gate_launches = fo.ADAMW_LAUNCHES - n0
        unc, unc_l, _ = _lenet_gate_run(paddle, state, five, 1, False)
        unf, unf_l, _ = _lenet_gate_run(paddle, state, five, 0, True)
        sc_cap, sc_l, sc_n = _lenet_gate_run(paddle, state, batches, 1, True,
                                             sched=True)
        sc_unc, sc_ul, _ = _lenet_gate_run(paddle, state, batches, 1, False,
                                           sched=True)
        rel_unc, leaf_unc = _param_rel(cap, unc)
        rel_unf, leaf_unf = _param_rel(cap, unf)
        rel_sched, leaf_sched = _param_rel(sc_cap, sc_unc)
        moved = _param_rel(sc_cap, {k: torch.as_tensor(v, device=dev)
                                    for k, v in state.items()})[0]
    finally:
        paddle.set_flags(old)
        torch.backends.cudnn.deterministic = old_det
    all_losses = fit_losses + timed + cap_l + unc_l + unf_l + sc_l + sc_ul
    ok = {"losses_finite": all(map(math.isfinite, all_losses)),
          "fit_steps": len(fit_losses) == -(-MNIST_TRAIN // LENET_BATCH),
          "two_captures": captures_fit == 2,
          "row7_launched": launches["fused_adamw"] == len(fit_losses),
          "gate_row7_launched": gate_launches == MODEL_GATE_STEPS
          and cap_n == 1 and sc_n == 1,
          "predict_after_load_bit_equal": bool(np.array_equal(preds, again)),
          "captured_vs_uncaptured": rel_unc <= MODEL_PARAM_REL,
          "captured_vs_unfused": rel_unf <= MODEL_PARAM_REL,
          "schedule_captured_vs_uncaptured": rel_sched <= MODEL_PARAM_REL,
          "schedule_moved_params": moved > 1e-4}
    row = {"phase": "train_paddle_model_lenet", "model": "LeNet",
           "config": "BASELINE config 1 (bench.py bench_lenet) through "
                     "paddle.Model",
           "batch": [LENET_BATCH, 1, 28, 28], "dtype": "float32",
           "optimizer": "Adam(lr=1e-3), FLAGS_fused_optimizer=1, "
                        "FLAGS_fast_step=1",
           "fit_steps": len(fit_losses), "fit_s": fit_s,
           "fit_samples_per_s": MNIST_TRAIN / fit_s,
           "fit_loss_first_last": [fit_losses[0], fit_losses[-1]],
           "eval": ev, "eval_s": eval_s, "captures": captures_fit,
           "train_step_host_ms_median": float(np.median(host_ms)),
           "step_ms_median": float(np.median(step_ms)),
           "eager_step_ms_phase37": eager_ms,
           "device_k": MODEL_K, "device_k_s": k_s,
           "device_samples_per_s": MODEL_K * LENET_BATCH / k_s,
           "peak_mem_gib": peak / 2**30,
           "peak_over_start_gib": (peak - base) / 2**30,
           "launches": launches,
           "gate_rel_captured_vs_uncaptured": rel_unc,
           "gate_rel_captured_vs_unfused": rel_unf,
           "gate_rel_schedule": rel_sched,
           "gate_leaf_worst": {"uncaptured": max(leaf_unc.values()),
                               "unfused": max(leaf_unf.values()),
                               "schedule": max(leaf_sched.values())},
           "tol_param_rel": MODEL_PARAM_REL,
           "schedule_params_moved_rel": moved,
           "seconds": time.perf_counter() - t_phase,
           "checks": ok, "ok": all(ok.values()), **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"paddle.Model LeNet phase failed: {ok}")
    return row


def resnet50_trainstep_phase(dev, mods, stamp, eager_ms):
    """Phase 42: BASELINE config 2 as bench_resnet50 times it, through
    jit.TrainStep (resnet50(num_classes=1000), amp.decorate O2 bf16, the
    loss under auto_cast O2, Momentum 0.1 / 0.9, batch 256 of
    3x224x224): RESNET_WARM calls (the first runs eagerly and captures),
    RESNET_CALLS per-call steps each read with float(loss) (the
    per-call dispatch rate), RESNET_K replays back to back with one host
    read (the device rate), one replay under torch.profiler; then the
    uncaptured step from the same weights on the same batch: its first 3
    losses against the captured step's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50

    paddle.set_device("gpu")
    paddle.seed(0)

    def build():
        model = paddle.amp.decorate(resnet50(num_classes=1000), level="O2",
                                    dtype="bfloat16")
        opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters())

        def loss_fn(run, x, y):
            with paddle.amp.auto_cast(enable=True, level="O2"):
                out = run(x)
            return paddle.nn.functional.cross_entropy(out, y)

        return model, opt, loss_fn

    rng = np.random.default_rng(0)
    images = paddle.to_tensor(rng.normal(
        size=(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE)).astype("float32"))
    labels = paddle.to_tensor(rng.integers(0, 1000, (RESNET_BATCH,)).astype(
        "int64"))
    model, opt, loss_fn = build()
    state = {k: v._data.detach().clone()
             for k, v in model.state_dict().items()}
    before = _bn_stats(model)
    _fresh_peak(dev)
    base = torch.cuda.memory_allocated(dev)
    _reset_vision_counts(mods)
    step = paddle.jit.TrainStep(model, loss_fn, opt)
    t0 = time.perf_counter()
    warm = [float(step(images, labels)) for _ in range(RESNET_WARM)]
    warm_s = time.perf_counter() - t0
    after3 = {k: v._data.detach().clone()
              for k, v in model.state_dict().items()}
    call_ms, losses = [], []
    for _ in range(RESNET_CALLS):
        t0 = time.perf_counter()
        losses.append(float(step(images, labels)))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(float(step.steps(RESNET_K, images, labels)))
    k_s = time.perf_counter() - t0
    replay_ms = k_s / RESNET_K * 1e3
    prof = _profiled_step(lambda: step(images, labels), replay_ms)
    launches = _vision_counts(mods)
    peak = torch.cuda.max_memory_allocated(dev)
    after = _bn_stats(model)
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    captures = step.captures
    del step
    _fresh_peak(dev)
    # the uncaptured step from the same weights on the same batch
    model.set_state_dict(state)
    opt2 = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=model.parameters())
    ref = paddle.jit.TrainStep(model, loss_fn, opt2, capture=False)
    ref_losses = [float(ref(images, labels)) for _ in range(RESNET_WARM)]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(warm, ref_losses))
    max_param = max((v._data.float() - after3[k].float()).abs().max().item()
                    for k, v in model.state_dict().items())
    del ref, model, opt, opt2, state, after3, before, after
    _fresh_peak(dev)
    ok = {"losses_finite": all(map(math.isfinite,
                                   warm + losses + ref_losses)),
          "bn_stats_moved": moved == 106,
          "one_capture": captures == 1,
          "first_losses_vs_uncaptured": rel_loss <= RESNET_STEP_LOSS_REL}
    row = {"phase": "train_paddle_trainstep_resnet50_o2", "model": "resnet50",
           "config": "BASELINE config 2 (bench.py bench_resnet50) through "
                     "jit.TrainStep",
           "batch": [RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE],
           "amp": "O2 bfloat16 (norms f32)",
           "optimizer": "Momentum(lr=0.1, momentum=0.9)",
           "warm_calls": RESNET_WARM, "warm_s": warm_s,
           "call_ms": call_ms,
           "call_ms_median": float(np.median(call_ms)),
           "per_call_samples_per_s":
               RESNET_BATCH / float(np.median(call_ms)) * 1e3,
           "k": RESNET_K, "replay_ms": replay_ms,
           "device_samples_per_s": RESNET_BATCH / replay_ms * 1e3,
           "eager_step_ms_phase38": eager_ms, **prof,
           "captures": captures, "peak_mem_gib": peak / 2**30,
           "peak_over_start_gib": (peak - base) / 2**30,
           "first_losses": warm, "first_losses_uncaptured": ref_losses,
           "first_loss_rel": rel_loss, "tol_loss_rel": RESNET_STEP_LOSS_REL,
           "max_abs_param_diff_after_3": max_param,
           "bn_buffers_moved": moved, "launches": launches,
           "checks": ok, "ok": all(ok.values()), **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"ResNet-50 TrainStep phase failed: {ok}")
    return row


# --------------------------------------------------------------------------
# phases 43-44: MobileNetV2 through jit.TrainStep, the new vision models
# card against CPU, and a sweep of the tensor and activation surface
# --------------------------------------------------------------------------

# phase 43: phase 42's recipe on mobilenet_v2(scale=1.0, num_classes=1000):
# warm-up calls, per-call steps, K replays; the first 3 captured losses
# against the uncaptured step from the same weights and generator state,
# relative (bf16 activations, the same kernels in the same order, the
# same dropout masks if the replays draw what the eager steps draw); the
# fresh-mask gate's replays at learning rate 0 on one batch
MOBILENET_WARM, MOBILENET_CALLS, MOBILENET_K = 3, 15, 10
MOBILENET_STEP_LOSS_REL = 1e-3
MOBILENET_FRESH_REPLAYS = 5
# phase 43b: each model at batch 2 of 3x224x224 in f32, card against the
# CPU port from the same weights (dropout off: the card's and the CPU's
# generators differ): the first loss relative, the last linear layer's
# weight gradient against the CPU's f64 run by phase 38's ratio rule (the
# card within "grad_vs_f64" times the CPU f32 run's distance from f64, or
# within "grad_floor" of the largest value, where both sit at f32's
# rounding floor and their ratio is noise), the first batch norm's running
# statistics after the step
VISION_CHECK_MODELS = ("mobilenet_v2", "mobilenet_v1", "alexnet", "vgg16",
                       "resnext50_32x4d")
VISION_CHECK_TOL = {"loss": 1e-5, "grad_vs_f64": 3.0, "grad_floor": 1e-5,
                    "stats": 1e-5}
# phase 44: every function this slice adds, on the card and on the CPU
# port from the same numpy inputs; f32 as max |Δ| / max |CPU|: elementwise
# 1e-5 (the same formula, the card's own libm and rounding), reductions,
# linalg and resizing 1e-4 (sums in another order; cuSOLVER against
# LAPACK); index outputs exactly on inputs without ties
SURFACE_TOL = {"elem": 1e-5, "reduce": 1e-4}
SURFACE_ROWS, SURFACE_COLS = 64, 1024
SURFACE_IMAGE = (8, 32, 56, 56)
# the names of tensor.__all__ and of nn.functional's activation and common
# modules that earlier slices ported: everything else there is this
# slice's, and phase 44 must sweep it
SURFACE_EARLIER = {
    "to_tensor", "zeros", "ones", "full", "arange", "add", "subtract",
    "multiply", "divide", "floor_divide", "remainder", "mod", "pow",
    "matmul", "mm", "bmm", "sum", "mean", "scale", "neg", "abs", "reshape",
    "transpose", "concat", "split", "unsqueeze", "cast", "flatten", "equal",
    "not_equal", "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "equal_all",
    "allclose", "isclose", "is_tensor", "relu", "gelu", "softmax", "linear",
    "dropout", "embedding"}


def mobilenet_v2_trainstep_phase(dev, mods, stamp):
    """Phase 43: MobileNetV2 at full width (scale 1.0, 1000 classes)
    through jit.TrainStep with phase 42's recipe (amp.decorate O2 bf16,
    the loss under auto_cast O2, Momentum 0.1 / 0.9, batch 256 of
    3x224x224 from seed 0): MOBILENET_WARM calls (the first eager, then
    the capture), MOBILENET_CALLS per-call steps, MOBILENET_K replays
    with one host read, one profiled replay; the first 3 captured losses
    against the uncaptured step from the same weights and generator
    state (the classifier's Dropout(0.2) drawing its masks in both), and
    MOBILENET_FRESH_REPLAYS replays at learning rate 0 on one batch,
    which must give at least two distinct losses (fresh masks a
    replay)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import mobilenet_v2

    paddle.set_device("gpu")
    paddle.seed(0)

    def build():
        model = paddle.amp.decorate(mobilenet_v2(scale=1.0, num_classes=1000),
                                    level="O2", dtype="bfloat16")
        opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters())

        def loss_fn(run, x, y):
            with paddle.amp.auto_cast(enable=True, level="O2"):
                out = run(x)
            return paddle.nn.functional.cross_entropy(out, y)

        return model, opt, loss_fn

    rng = np.random.default_rng(0)
    images = paddle.to_tensor(rng.normal(
        size=(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE)).astype("float32"))
    labels = paddle.to_tensor(rng.integers(0, 1000, (RESNET_BATCH,)).astype(
        "int64"))
    model, opt, loss_fn = build()
    state = {k: v._data.detach().clone()
             for k, v in model.state_dict().items()}
    gen_state = paddle.get_rng_state()
    before = _bn_stats(model)
    _fresh_peak(dev)
    base = torch.cuda.memory_allocated(dev)
    _reset_vision_counts(mods)
    step = paddle.jit.TrainStep(model, loss_fn, opt)
    t0 = time.perf_counter()
    warm = [float(step(images, labels)) for _ in range(MOBILENET_WARM)]
    warm_s = time.perf_counter() - t0
    call_ms, losses = [], []
    for _ in range(MOBILENET_CALLS):
        t0 = time.perf_counter()
        losses.append(float(step(images, labels)))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(float(step.steps(MOBILENET_K, images, labels)))
    k_s = time.perf_counter() - t0
    replay_ms = k_s / MOBILENET_K * 1e3
    prof = _profiled_step(lambda: step(images, labels), replay_ms)
    launches = _vision_counts(mods)
    peak = torch.cuda.max_memory_allocated(dev)
    after = _bn_stats(model)
    moved = sum(not torch.equal(before[k], after[k]) for k in before)
    # fresh masks: the same batch, no update, only the dropout draws move
    step.scale_lr(0.0)
    fresh = [float(step(images, labels))
             for _ in range(MOBILENET_FRESH_REPLAYS)]
    captures = step.captures
    del step
    _fresh_peak(dev)
    # the uncaptured step from the same weights and generator state
    model.set_state_dict(state)
    paddle.set_rng_state(gen_state)
    opt2 = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=model.parameters())
    ref = paddle.jit.TrainStep(model, loss_fn, opt2, capture=False)
    ref_losses = [float(ref(images, labels)) for _ in range(MOBILENET_WARM)]
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(warm, ref_losses))
    del ref, model, opt, opt2, state, before, after
    _fresh_peak(dev)
    ok = {"losses_finite": all(map(math.isfinite,
                                   warm + losses + ref_losses + fresh)),
          "bn_stats_moved": moved == 104,
          "one_capture": captures == 1,
          "first_losses_vs_uncaptured": rel_loss <= MOBILENET_STEP_LOSS_REL,
          "fresh_masks": len(set(fresh)) >= 2}
    row = {"phase": "train_paddle_trainstep_mobilenet_v2_o2",
           "model": "mobilenet_v2(scale=1.0, num_classes=1000)",
           "batch": [RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE],
           "amp": "O2 bfloat16 (norms f32)",
           "optimizer": "Momentum(lr=0.1, momentum=0.9)",
           "dropout": "classifier Dropout(0.2) active in every step "
                      "compared (captured and uncaptured draw from the "
                      "same generator state)",
           "warm_calls": MOBILENET_WARM, "warm_s": warm_s,
           "call_ms": call_ms,
           "call_ms_median": float(np.median(call_ms)),
           "per_call_samples_per_s":
               RESNET_BATCH / float(np.median(call_ms)) * 1e3,
           "k": MOBILENET_K, "replay_ms": replay_ms,
           "device_samples_per_s": RESNET_BATCH / replay_ms * 1e3, **prof,
           "captures": captures, "peak_mem_gib": peak / 2**30,
           "peak_over_start_gib": (peak - base) / 2**30,
           "first_losses": warm, "first_losses_uncaptured": ref_losses,
           "first_loss_rel": rel_loss,
           "tol_loss_rel": MOBILENET_STEP_LOSS_REL,
           "fresh_mask_losses_lr0": fresh, "bn_buffers_moved": moved,
           "launches": launches, "checks": ok, "ok": all(ok.values()),
           **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"MobileNetV2 TrainStep phase failed: {ok}")
    return row


def vision_models_check_phase(dev, stamp, batch=2, card="gpu",
                              side=RESNET_SIDE):
    """Phase 43b: each of VISION_CHECK_MODELS in f32 at ``batch`` x
    3x224x224, one Momentum step on the card against the CPU port with
    the same weights (and the CPU in f64 as the gradients' yardstick),
    dropout off: the first loss, the last linear layer's weight gradient
    and the first batch norm's running statistics after the step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import models as M

    rng = np.random.default_rng(43)
    images = rng.normal(size=(batch, 3, side, side)).astype("float32")
    labels = rng.integers(0, 1000, (batch,)).astype("int64")
    rows = {}
    try:
        for name in VISION_CHECK_MODELS:
            out, state = {}, None
            for run, where, dt in (("cpu", "cpu", "float32"),
                                   ("cpu_f64", "cpu", "float64"),
                                   ("card", card, "float32")):
                paddle.set_device(where)
                paddle.seed(43)
                model = getattr(M, name)()
                if state is None:       # the CPU f32 model's own weights
                    state = {k: v.numpy()
                             for k, v in model.state_dict().items()}
                else:
                    model.set_state_dict(state)
                model.to(dtype=dt)
                for layer in model.sublayers():
                    if isinstance(layer, paddle.nn.Dropout):
                        layer.p = 0.0
                opt = paddle.optimizer.Momentum(
                    learning_rate=0.1, momentum=0.9,
                    parameters=model.parameters())
                t0 = time.perf_counter()
                loss = paddle.nn.functional.cross_entropy(
                    model(paddle.to_tensor(images, dtype=dt)),
                    paddle.to_tensor(labels))
                loss.backward()
                head = [m for m in model.sublayers()
                        if isinstance(m, paddle.nn.Linear)][-1]
                grad = head.weight.grad._data.cpu()
                opt.step()
                bns = [m for m in model.sublayers()
                       if isinstance(m, paddle.nn.BatchNorm2D)]
                stats = ({k: bns[0]._buffers[k]._data.cpu()
                          for k in ("_mean", "_variance")} if bns else {})
                out[run] = (float(loss), grad, stats,
                            time.perf_counter() - t0)
                del model, opt, loss, head, bns
            (l_cpu, g_cpu, s_cpu, t_cpu), (_, g64, _, t64), (
                l_card, g_card, s_card, t_card) = (out["cpu"], out["cpu_f64"],
                                                   out["card"])
            err = {"loss": abs(l_card - l_cpu) / abs(l_cpu),
                   "grad": _rel(g_card, g_cpu),
                   "grad_card_vs_f64": _rel(g_card, g64),
                   "grad_cpu_vs_f64": _rel(g_cpu, g64),
                   "stats": {k: _rel(s_card[k], s) for k, s in s_cpu.items()}}
            tol = VISION_CHECK_TOL
            ok = {"loss": err["loss"] <= tol["loss"],
                  "grad": err["grad_card_vs_f64"] <= max(
                      tol["grad_vs_f64"] * err["grad_cpu_vs_f64"],
                      tol["grad_floor"]),
                  "stats": max(err["stats"].values(), default=0.0)
                  <= tol["stats"]}
            rows[name] = {"loss_card": l_card, "loss_cpu": l_cpu,
                          "err": err, "checks": ok, "card_s": t_card,
                          "cpu_s": t_cpu, "cpu_f64_s": t64,
                          "ok": all(ok.values())}
            del out, state
            gc.collect()
    finally:
        paddle.set_device(card)
    row = {"phase": "paddle_vision_models_card_vs_cpu",
           "models": rows, "batch": [batch, 3, side, side],
           "dtype": "float32", "dropout": "p = 0 (the generators differ)",
           "tol": VISION_CHECK_TOL,
           "ok": all(r["ok"] for r in rows.values()), **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"vision models: card and CPU disagree: {row}")
    return row


def _surface_cases():
    """(name, the functions it covers, fn(paddle, *tensors), numpy
    inputs, kind, differentiable) for phase 44. Kinds: "elem" and
    "reduce" compare values at SURFACE_TOL, "index" exactly, "abs" the
    absolute values (factors defined up to sign), "eig" the eigenvalues
    sorted, "random" only device, dtype and shape."""
    rng = np.random.default_rng(44)
    R, C = SURFACE_ROWS, SURFACE_COLS
    x = rng.normal(size=(R, C)).astype("float32")
    y = rng.normal(size=(R, C)).astype("float32")
    pos = rng.uniform(0.5, 2.0, (R, C)).astype("float32")
    unit = rng.uniform(-0.9, 0.9, (R, C)).astype("float32")
    perm = (np.stack([rng.permutation(C) for _ in range(R)]).astype(
        "float32") - C / 2) / 16                     # rows without ties
    ints = rng.integers(-50, 50, (R, C)).astype("int64")
    pints = rng.integers(1, 50, (R, C)).astype("int64")
    img = rng.normal(size=SURFACE_IMAGE).astype("float32")
    mat = rng.normal(size=(64, 64)).astype("float32")
    spd = (mat @ mat.T / 64 + np.eye(64)).astype("float32")
    # 16 x 16 with spectra 1, 2, ..., 16: singular vectors and
    # eigenvectors well defined (a clustered spectrum leaves them free
    # within the cluster; at 64 x 64 spaced 1/7 apart cuSOLVER's vectors
    # sat 8.3e-5 from LAPACK's)
    q1 = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    q2 = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    spread = np.arange(1.0, 17.0)
    sep = (q1 * spread @ q2.T).astype("float32")
    sym = (q1 * spread @ q1.T).astype("float32")
    vec = rng.normal(size=(64,)).astype("float32")
    small = rng.integers(0, 100, (R, C)).astype("int64")
    idx = rng.integers(0, C, (256,)).astype("int64")
    rows = rng.permutation(R)[:16].astype("int64")
    cases = []

    def add(name, fn, arrays, kind="elem", grad=False, covers=None):
        cases.append((name, covers or (name,), fn, arrays, kind, grad))

    unary = {
        "exp": x, "expm1": x, "log": pos, "log2": pos, "log10": pos,
        "log1p": pos, "sqrt": pos, "rsqrt": pos, "square": x, "sign": x,
        "floor": x * 4, "ceil": x * 4, "round": x * 4, "trunc": x * 4,
        "sin": x, "cos": x, "tan": unit, "asin": unit, "acos": unit,
        "atan": x, "sinh": x, "cosh": x, "tanh": x, "asinh": x,
        "acosh": pos + 1, "atanh": unit, "reciprocal": pos, "sigmoid": x,
        "erf": x, "erfinv": unit, "lgamma": pos, "digamma": pos,
        "isnan": x, "isinf": x, "isfinite": x, "deg2rad": x,
        "rad2deg": x, "frac": x * 4, "angle": x, "conj": x, "real": x,
        "imag": x}
    smooth = {"exp", "log", "sqrt", "tanh", "sin", "sigmoid", "erf",
              "lgamma"}
    for n, a in unary.items():
        add(n, (lambda n: lambda p, t: getattr(p, n)(t))(n), [a], "elem",
            n in smooth)
    for n in ("maximum", "minimum", "fmax", "fmin", "atan2", "floor_mod",
              "heaviside"):
        add(n, (lambda n: lambda p, a, b: getattr(p, n)(a, b))(n),
            [x * 3, pos if n == "floor_mod" else y], "elem",
            n in ("maximum", "atan2"))
    for n in ("gcd", "lcm"):
        add(n, (lambda n: lambda p, a, b: getattr(p, n)(a, b))(n),
            [ints, pints], "index")
    for n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(n, (lambda n: lambda p, a, b: getattr(p, n)(a, b))(n),
            [ints, pints], "index")
    add("bitwise_not", lambda p, a: p.bitwise_not(a), [ints], "index")
    add("clip", lambda p, a: p.clip(a, -0.5, 0.7), [x], "elem", True)
    add("stanh", lambda p, a: p.stanh(a), [x], "elem")
    add("lerp", lambda p, a, b: p.lerp(a, b, 0.3), [x, y], "elem", True)
    add("increment", lambda p, a: p.increment(a * 1.0, 2.0), [x])
    add("nan_to_num", lambda p, a: p.nan_to_num(p.log(a)), [x])
    add("kron", lambda p, a, b: p.kron(a, b), [mat[:8, :8], mat[8:16, :8]])
    add("dot", lambda p, a, b: p.dot(a, b), [mat, spd], "reduce", True)
    add("inner", lambda p, a, b: p.inner(a, b), [x[:8], y[:8]], "reduce")
    add("outer", lambda p, a, b: p.outer(a, b), [vec, vec])
    add("addmm", lambda p, i, a, b: p.addmm(i, a, b, 0.5, 2.0),
        [mat, mat, spd], "reduce", True)
    add("mv", lambda p, a, v: p.mv(a, v), [mat, vec], "reduce")
    add("multiplex", lambda p, a, b, i: p.multiplex([a, b], i),
        [mat, spd, (np.arange(64) % 2).reshape(64, 1)], "index")
    add("add_n", lambda p, a, b: p.add_n([a, b, a]), [x, y], "elem", True)
    add("diagonal", lambda p, a: p.diagonal(a, 1), [mat])
    add("trace", lambda p, a: p.trace(a), [mat], "reduce")
    add("diff", lambda p, a: p.diff(a, axis=1), [x], "elem", True)
    add("rot90", lambda p, a: p.rot90(a), [x], "index")
    add("count_nonzero", lambda p, a: p.count_nonzero(a, axis=1), [ints],
        "index")
    add("logcumsumexp", lambda p, a: p.logcumsumexp(a, axis=1), [x],
        "reduce", True)
    add("nansum", lambda p, a: p.nansum(p.log(a), axis=1), [x], "reduce")
    add("nanmean", lambda p, a: p.nanmean(p.log(a), axis=0), [x], "reduce")
    for n in ("max", "min", "amax", "amin", "prod", "logsumexp", "std",
              "var", "median"):
        a = pos if n == "prod" else x
        add(n, (lambda n: lambda p, t: getattr(p, n)(t, axis=1))(n),
            [a[:, :64] if n == "prod" else a], "reduce", n != "median")
        add(n + "_all", (lambda n: lambda p, t: getattr(p, n)(t))(n),
            [a[:8, :16] if n == "prod" else a], "reduce", False, (n,))
    add("cumsum", lambda p, a: p.cumsum(a, axis=1), [x], "reduce", True)
    add("cumprod", lambda p, a: p.cumprod(a, dim=1), [pos[:, :32]],
        "reduce", True)
    add("all", lambda p, a: p.all(a > -3.0, axis=1), [x], "index")
    add("any", lambda p, a: p.any(a > 3.0, axis=0), [x], "index")
    add("tanh_", lambda p, a: p.tanh_(a * 1.0), [x])
    # manipulation
    add("stack", lambda p, a, b: p.stack([a, b], axis=1), [x, y], "elem",
        True)
    add("chunk", lambda p, a: p.chunk(a, 4, axis=1), [x])
    add("split_sections", lambda p, a: p.split_sections(a, [512, -1], 1),
        [x])
    add("squeeze", lambda p, a: p.squeeze(p.unsqueeze(a, 1), axis=1), [x])
    add("flip", lambda p, a: p.flip(a, [0, 1]), [x])
    add("reverse", lambda p, a: p.reverse(a, 1), [x])
    add("roll", lambda p, a: p.roll(a, [3, -5], [0, 1]), [x])
    add("tile", lambda p, a: p.tile(a[:8], [2, 3]), [x], "elem", True)
    add("expand", lambda p, a: p.expand(a[:1], [4, -1]), [x], "elem", True)
    add("expand_as", lambda p, a, b: p.expand_as(a[:1], b), [x, y])
    add("broadcast_to", lambda p, a: p.broadcast_to(a[:1], [8, C]), [x])
    add("broadcast_tensors",
        lambda p, a, b: p.broadcast_tensors([a[:1], b[:, :1]]), [x, y])
    add("broadcast_shape", lambda p: p.to_tensor(
        p.broadcast_shape([64, 1], [1, 1024])), [], "index")
    add("gather", lambda p, a, i: p.gather(a, i, axis=1), [x, idx], "elem",
        True)
    add("gather_nd", lambda p, a, i: p.gather_nd(a, i),
        [x, np.stack([rows, idx[:16]], 1)], "elem", True)
    add("index_select", lambda p, a, i: p.index_select(a, i), [x, rows])
    add("index_sample", lambda p, a, i: p.index_sample(a, i),
        [x, idx.reshape(64, 4)], "elem", True)
    add("index_add", lambda p, a, i, v: p.index_add(a, i, 0, v),
        [x, rows, y[:16]], "reduce", True)
    add("scatter", lambda p, a, i, u: p.scatter(a, i, u), [x, rows, y[:16]],
        "elem", True)
    add("scatter_", lambda p, a, i, u: p.scatter_(a * 1.0, i, u),
        [x, rows, y[:16]])
    add("scatter_nd_add", lambda p, a, i, u: p.scatter_nd_add(a, i, u),
        [x, np.concatenate([rows, rows])[:, None], y[:32]], "reduce", True)
    add("scatter_nd", lambda p, i, u: p.scatter_nd(i, u, [R, C]),
        [np.concatenate([rows, rows])[:, None], y[:32]], "reduce")
    add("masked_select", lambda p, a: p.masked_select(a, a > 1.0), [x],
        "elem", True)
    add("where", lambda p, a, b: p.where(a > 0, a, b), [x, y], "elem", True)
    add("nonzero", lambda p, a: p.nonzero(a > 2.0), [x], "index")
    add("slice", lambda p, a: p.slice(a, [0, 1], [3, 100], [40, 900]), [x])
    add("strided_slice", lambda p, a: p.strided_slice(
        a, [0, 1], [60, 900], [2, 10], [-3, -7]), [x], "elem", True)
    add("crop", lambda p, a: p.crop(a, [16, 256], [8, 100]), [x])
    add("unbind", lambda p, a: p.unbind(a[:4], 0), [x])
    add("unstack", lambda p, a: p.unstack(a[:, :4], 1), [x])
    add("unique", lambda p, a: p.unique(a, return_index=True,
                                        return_inverse=True,
                                        return_counts=True), [small],
        "index")
    add("unique_consecutive", lambda p, a: p.unique_consecutive(
        a, return_inverse=True, return_counts=True),
        [np.sort(small // 7, axis=None)], "index")
    add("repeat_interleave", lambda p, a: p.repeat_interleave(a, 3, 1),
        [x[:, :256]], "elem", True)
    add("take_along_axis", lambda p, a, i: p.take_along_axis(a, i, 1),
        [x, idx.reshape(64, 4)], "elem", True)
    add("put_along_axis", lambda p, a, i, v: p.put_along_axis(a, i, v, 1),
        [x, np.argsort(perm, 1)[:, :4], y[:, :4]])
    add("moveaxis", lambda p, a: p.moveaxis(a, 0, 2), [img[:2]])
    add("tensordot", lambda p, a, b: p.tensordot(a, b, [[1], [1]]),
        [x[:16], y[:16]], "reduce", True)
    add("as_real", lambda p, a: p.as_real(p.as_complex(a)),
        [x.reshape(R, C // 2, 2)], "elem", False, ("as_real", "as_complex"))
    add("pad", lambda p, a: p.pad(a, [1, 2, 3, 4], mode="reflect"), [img],
        "elem", True)
    add("tolist", lambda p, a: p.to_tensor(p.tolist(a[:2, :3])), [ints],
        "index")
    add("shape", lambda p, a: p.shape(a), [img], "index")
    add("rank", lambda p, a: p.rank(a), [img], "index")
    add("shard_index", lambda p, a: p.shard_index(a, 100, 4, 2), [small],
        "index")
    add("reshape_", lambda p, a: p.reshape_(a * 1.0, [C, R]), [x])
    add("squeeze_", lambda p, a: p.squeeze_(a[None] * 1.0, 0), [x])
    add("unsqueeze_", lambda p, a: p.unsqueeze_(a * 1.0, 1), [x])
    # creation
    add("zeros_like", lambda p, a: p.zeros_like(a), [x])
    add("ones_like", lambda p, a: p.ones_like(a, dtype="int32"), [x],
        "index")
    add("full_like", lambda p, a: p.full_like(a, 2.5), [x])
    add("empty", lambda p: p.empty([R, C]), [])
    add("empty_like", lambda p, a: p.empty_like(a), [x])
    add("linspace", lambda p: p.linspace(-3.0, 5.0, C), [])
    add("logspace", lambda p: p.logspace(0.0, 3.0, C, base=2.0), [])
    add("eye", lambda p: p.eye(R, C), [])
    add("tril", lambda p, a: p.tril(a, -1), [mat], "elem", True)
    add("triu", lambda p, a: p.triu(a, 2), [mat])
    add("diag", lambda p, v: p.diag(v, 1, padding_value=3.0), [vec])
    add("diagflat", lambda p, a: p.diagflat(a), [mat[:4]])
    add("meshgrid", lambda p, a, b: p.meshgrid(a, b), [vec, vec[:10]])
    add("assign", lambda p, a: p.assign(a), [x])
    add("clone", lambda p, a: p.clone(a), [x], "elem", True)
    add("numel", lambda p, a: p.numel(a), [img], "index")
    add("complex", lambda p, a, b: p.complex(a, b), [x, y])
    add("create_parameter", lambda p: p.create_parameter([R, C], "float32"),
        [], "random")
    add("check_shape", lambda p: (p.check_shape([R, -1]) or
                                  p.to_tensor([1])), [], "index")
    add("is_empty", lambda p, a: p.is_empty(a), [x], "index")
    add("einsum", lambda p, a, b: p.einsum("ij,kj->ik", a, b),
        [x[:32], y[:16]], "reduce", True)
    # search
    add("argmax", lambda p, a: p.argmax(a, axis=1), [perm], "index")
    add("argmin", lambda p, a: p.argmin(a, axis=0), [perm.T.copy()],
        "index")
    add("argsort", lambda p, a: p.argsort(a, axis=1, descending=True),
        [perm], "index")
    add("sort", lambda p, a: p.sort(a, axis=1), [x], "elem", True)
    add("topk", lambda p, a: p.topk(a, 8, axis=1), [perm], "index")
    add("searchsorted", lambda p, s, v: p.searchsorted(s, v, right=True),
        [np.sort(x, axis=1), y[:, :100]], "index")
    add("kthvalue", lambda p, a: p.kthvalue(a, 100, axis=1), [perm],
        "index")
    add("mode", lambda p, a: p.mode(a), [small // 5], "index")
    # linalg
    add("norm", lambda p, a: p.norm(a, p=3, axis=1), [x], "reduce", True)
    add("dist", lambda p, a, b: p.dist(a, b), [x, y], "reduce", True)
    add("t", lambda p, a: p.t(a), [mat])
    add("cross", lambda p, a, b: p.cross(a, b), [x[:3], y[:3]], "reduce",
        True)
    add("cholesky", lambda p, a: p.cholesky(a), [spd], "reduce", True)
    add("qr", lambda p, a: p.linalg.qr(a), [mat], "abs")
    add("svd", lambda p, a: p.linalg.svd(a), [sep], "abs")
    add("inv", lambda p, a: p.inv(a), [spd], "reduce", True,
        ("inv", "inverse"))
    add("det", lambda p, a: p.linalg.det(a / 2), [spd], "reduce")
    add("slogdet", lambda p, a: p.linalg.slogdet(a), [mat], "reduce")
    add("solve", lambda p, a, b: p.linalg.solve(a, b), [spd, mat], "reduce",
        True)
    add("triangular_solve", lambda p, a, b: p.triangular_solve(a, b),
        [np.triu(spd), mat], "reduce")
    add("matrix_power", lambda p, a: p.linalg.matrix_power(a, 3),
        [spd / 2], "reduce")
    add("pinv", lambda p, a: p.linalg.pinv(a), [mat[:, :40]], "reduce")
    add("multi_dot", lambda p, a, b: p.linalg.multi_dot([a, b, a]),
        [mat, spd], "reduce")
    add("eig", lambda p, a: p.linalg.eig(a)[0], [mat], "eig")
    add("eigvals", lambda p, a: p.linalg.eigvals(a), [mat], "eig")
    add("eigh", lambda p, a: p.linalg.eigh(a), [sym], "abs")
    add("eigvalsh", lambda p, a: p.eigvalsh(a), [spd], "reduce")
    add("matrix_rank", lambda p, a: p.linalg.matrix_rank(a),
        [np.concatenate([mat[:40], mat[:24] * 2])], "index")
    add("histogram", lambda p, a: p.histogram(a, 100, -0.5, 99.5), [small],
        "index")
    add("bincount", lambda p, a: p.bincount(a, minlength=120),
        [small.reshape(-1)], "index")
    add("lu", lambda p, a: p.lu(a), [mat], "reduce")
    add("lstsq", lambda p, a, b: p.linalg.lstsq(a, b),
        [np.concatenate([mat, spd]), mat[:, :8].repeat(2, 0)], "reduce")
    add("cov", lambda p, a: p.cov(a), [mat], "reduce")
    add("corrcoef", lambda p, a: p.corrcoef(a), [mat], "reduce")
    add("cond", lambda p, a: p.linalg.cond(a), [spd], "reduce")
    # activations
    F_act = {
        "relu6": x * 4, "sigmoid": x, "tanh": x, "silu": x, "swish": x,
        "mish": x, "log_softmax": x, "leaky_relu": x, "elu": x, "selu": x,
        "celu": x, "hardshrink": x, "hardsigmoid": x * 4, "hardswish": x * 4,
        "hardtanh": x, "softplus": x, "softshrink": x, "softsign": x,
        "tanhshrink": x, "thresholded_relu": x * 2, "glu": x,
        "log_sigmoid": x}
    for n, a in F_act.items():
        add(n, (lambda n: lambda p, t: getattr(p.nn.functional, n)(t))(n),
            [a], "elem", n in ("mish", "selu", "log_softmax", "glu"),
            (n,))
    add("maxout", lambda p, a: p.nn.functional.maxout(a, 4), [img],
        "elem", True)
    add("prelu", lambda p, a, w: p.nn.functional.prelu(a, w),
        [img, np.linspace(0.1, 0.4, 32).astype("float32")], "elem", True)
    add("rrelu", lambda p, a: p.nn.functional.rrelu(a), [x], "random")
    add("gumbel_softmax", lambda p, a: p.nn.functional.gumbel_softmax(a),
        [x], "random")
    for n in ("relu_", "elu_", "softmax_"):
        add(n, (lambda n: lambda p, a: getattr(p.nn.functional, n)(
            a * 1.0))(n), [x])
    # the common functionals
    add("dropout2d", lambda p, a: p.nn.functional.dropout2d(a), [img],
        "random")
    add("dropout3d", lambda p, a: p.nn.functional.dropout3d(
        p.unsqueeze(a, 2)), [img], "random")
    add("alpha_dropout", lambda p, a: p.nn.functional.alpha_dropout(a),
        [x], "random")
    for mode, size, ac in (("nearest", (112, 100), False),
                           ("nearest", (28, 42), True),
                           ("bilinear", (80, 30), False),
                           ("bilinear", (112, 112), True),
                           ("bicubic", (100, 64), False),
                           ("bicubic", (28, 28), False)):
        add(f"interpolate_{mode}_{size[0]}x{size[1]}_{ac}",
            (lambda m, s, ac: lambda p, a: p.nn.functional.interpolate(
                a, size=list(s), mode=m, align_corners=ac))(mode, size, ac),
            [img], "reduce", mode == "bilinear", ("interpolate",))
    add("upsample", lambda p, a: p.nn.functional.upsample(
        a, scale_factor=2, mode="bilinear"), [img], "reduce")
    add("unfold", lambda p, a: p.nn.functional.unfold(a, 3, 1, 1), [img],
        "elem", True)
    add("fold", lambda p, a: p.nn.functional.fold(a, [56, 56], 3, 1, 1),
        [rng.normal(size=(2, 288, 3136)).astype("float32")], "reduce",
        True)
    add("cosine_similarity", lambda p, a, b: p.nn.functional.
        cosine_similarity(a, b), [x, y], "reduce", True)
    add("pixel_shuffle", lambda p, a: p.nn.functional.pixel_shuffle(a, 2),
        [img], "elem")
    add("pixel_unshuffle", lambda p, a: p.nn.functional.pixel_unshuffle(
        a, 2), [img], "elem")
    add("normalize", lambda p, a: p.nn.functional.normalize(a), [x],
        "reduce", True)
    add("label_smooth", lambda p, a: p.nn.functional.label_smooth(a),
        [np.eye(C, dtype="float32")[small[0, :R] % C]])
    add("one_hot", lambda p, a: p.nn.functional.one_hot(a, 100),
        [small[0]], "index")
    add("class_center_sample", lambda p, a: p.nn.functional.
        class_center_sample(a, 1000, 200), [small[0]], "random")
    add("bilinear", lambda p, a, b, w: p.nn.functional.bilinear(a, b, w),
        [x[:, :32], y[:, :48], rng.normal(size=(16, 32, 48)).astype(
            "float32")], "reduce", True)
    grid = rng.uniform(-1.1, 1.1, (8, 28, 28, 2)).astype("float32")
    for pm in ("zeros", "border", "reflection"):
        add(f"grid_sample_{pm}", (lambda pm: lambda p, a, g: p.nn.functional
                                  .grid_sample(a, g, padding_mode=pm))(pm),
            [img, grid], "reduce", pm == "zeros", ("grid_sample",))
    add("affine_grid", lambda p, t: p.nn.functional.affine_grid(
        t, [8, 32, 56, 56]), [rng.normal(size=(8, 2, 3)).astype("float32")],
        "reduce", True)
    return cases


def _sweep_run(paddle, where, fn, arrays, grad):
    paddle.set_device(where)
    ts = [paddle.to_tensor(a, stop_gradient=not (grad and a.dtype.kind
                                                 == "f"))
          for a in arrays]
    outs = fn(paddle, *ts)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    grads = []
    if grad:
        w = np.random.default_rng(45).normal(size=outs[0].shape).astype(
            "float32")
        outs[0].backward(paddle.to_tensor(w))
        grads = [t.grad for t in ts if not t.stop_gradient]
    return outs, grads


def _sweep_err(kind, card, cpu):
    """(max |Δ| / max |CPU|, exact equality) of one output."""
    c, h = card._data.detach().cpu(), cpu._data.detach()
    if kind == "eig":
        key = lambda v: v[np.lexsort((np.round(v.imag, 3),  # noqa: E731
                                      np.round(v.real, 3)))]
        c, h = (torch.as_tensor(key(v.numpy())) for v in (c, h))
    if kind == "abs":
        c, h = c.abs(), h.abs()
    if c.is_complex():
        c, h = torch.view_as_real(c), torch.view_as_real(h)
    if not (c.is_floating_point()):
        return 0.0, bool(torch.equal(c, h))
    return _rel(c, h), True


def surface_sweep_phase(dev, stamp, card="gpu"):
    """Phase 44: every function this slice adds (the names of
    tensor.__all__, paddle.linalg and nn.functional's activation and
    common modules that SURFACE_EARLIER does not list) on the card and on
    the CPU port from the same numpy inputs, one moderate shape a kind
    ((64, 1024) f32, an (8, 32, 56, 56) image, 64 x 64 matrices): each
    output on the card in the CPU output's dtype and shape, values
    within SURFACE_TOL, index outputs exactly, and the differentiable
    ones' input gradients at their kind's tolerance. A name no case
    covers fails the phase."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import linalg, tensor
    from paddle_tpu_torch.nn.functional import activation, common

    # tensor/random.py came with a later slice: phase 46 sweeps it
    want = (set(tensor.__all__) | set(linalg.__all__)
            | set(activation.__all__) | set(common.__all__)) \
        - SURFACE_EARLIER - set(tensor.random.__all__)
    cases = _surface_cases()
    covered = {n for _, covers, *_ in cases for n in covers}
    t_phase = time.perf_counter()
    worst = {"elem": (0.0, None), "reduce": (0.0, None),
             "grad": (0.0, None)}
    bad, n_grads = [], 0
    try:
        for name, covers, fn, arrays, kind, grad in cases:
            paddle.seed(44)
            c_outs, c_grads = _sweep_run(paddle, card, fn, arrays, grad)
            paddle.seed(44)
            h_outs, h_grads = _sweep_run(paddle, "cpu", fn, arrays, grad)
            tol = SURFACE_TOL["elem" if kind == "elem" else "reduce"]
            if len(c_outs) != len(h_outs):
                bad.append((name, "output count"))
                continue
            for c, h in zip(c_outs, h_outs):
                if (c.place.type != torch.device(card.replace(
                        "gpu", "cuda")).type or c.dtype != h.dtype
                        or c.shape != h.shape):
                    bad.append((name, "device, dtype or shape",
                                str(c.place), str(c.dtype), str(h.dtype)))
                    continue
                if kind == "random":
                    continue
                err, equal = _sweep_err(kind, c, h)
                if kind == "index" and (err or not equal):
                    bad.append((name, "index outputs differ"))
                elif not equal or err > tol:
                    bad.append((name, "values", err))
                key = "elem" if kind == "elem" else "reduce"
                if kind != "index" and err > worst[key][0]:
                    worst[key] = (err, name)
            for c, h in zip(c_grads, h_grads):
                n_grads += 1
                if c is None or h is None:
                    if (c is None) != (h is None):
                        bad.append((name, "gradient missing"))
                    continue
                err = _rel(c._data.cpu(), h._data)
                if err > tol:
                    bad.append((name, "gradient", err))
                if err > worst["grad"][0]:
                    worst["grad"] = (err, name)
    finally:
        paddle.set_device(card)
    missing = sorted(want - covered)
    row = {"phase": "paddle_surface_sweep_card_vs_cpu",
           "functions_swept": len(want & covered), "functions_new":
           len(want), "cases": len(cases), "gradients_compared": n_grads,
           "missing": missing, "failures": bad[:20],
           "worst_err": {k: {"err": v[0], "case": v[1]}
                         for k, v in worst.items()},
           "tol": SURFACE_TOL, "shapes": {
               "rows": [SURFACE_ROWS, SURFACE_COLS],
               "image": list(SURFACE_IMAGE), "matrix": [64, 64]},
           "seconds": time.perf_counter() - t_phase,
           "ok": not bad and not missing, **stamp}
    emit(row)
    print(f"surface sweep: {row['functions_swept']} functions in "
          f"{len(cases)} cases, worst errors {row['worst_err']}",
          flush=True)
    if not row["ok"]:
        raise AssertionError(f"surface sweep failed: {bad[:20]} "
                             f"missing {missing}")
    return row


# --------------------------------------------------------------------------
# phases 45-46: PaddleNLP's attention seq2seq (IWSLT'15 en->vi) trained
# through jit.TrainStep and beam-decoded, and a sweep of the rest of
# paddle.nn
# --------------------------------------------------------------------------

# PaddleNLP examples/machine_translation/seq2seq at its published IWSLT'15
# en->vi settings: the vocabularies, embedding and hidden width, depth,
# dropout and init scale; batches of 128 with lengths 10-50 padded to 50;
# Adam 1e-3 with a global-norm clip of 5; beam 10, max_out_len 256
S2S = {"src_vocab": 17191, "trg_vocab": 7709, "hidden": 512, "layers": 2,
       "dropout": 0.2, "init_scale": 0.1}
S2S_BATCH, S2S_MAXLEN, S2S_LENS = 128, 50, (10, 50)
S2S_BOS, S2S_EOS = 0, 1
S2S_LR, S2S_CLIP = 1e-3, 5.0
S2S_BEAM, S2S_MAX_OUT = 10, 256
S2S_WARM, S2S_EAGER, S2S_CALLS, S2S_K = 3, 5, 10, 10
# phase 45: the first 3 captured losses against the uncaptured step's from
# the same weights and generator state (the same kernels on the same
# inputs, the same dropout masks), relative
S2S_CAPTURE_LOSS_REL = 1e-6
# phase 45b: the model in f32 at batch 2 on the card against the CPU port
# with the same weights (dropout off): the first loss relative, each
# gradient as max |d| / max |CPU|, a 32-step beam decode's scores
# (absolute: sums of 32 log-probabilities), and the gap between the K-th
# and (K+1)-th totals under which two decodes may part (a near tie)
S2S_CHECK_BATCH, S2S_CHECK_STEPS = 2, 32
S2S_CHECK_TOL = {"loss": 1e-5, "grad": 1e-4, "score": 1e-4, "tie": 1e-5}


def seq2seq_model(paddle, src_vocab, trg_vocab, hidden, layers, dropout=0.0,
                  init_scale=0.1):
    """PaddleNLP's attention seq2seq (``seq2seq_attn.py``) as a Paddle
    user writes it, on either package's Paddle surface (``paddle_tpu`` or
    ``paddle_tpu_torch``): a source embedding and an ``nn.LSTM`` encoder
    that reads ``sequence_length``; a decoder cell of ``LSTMCell``s fed
    the target embedding and the previous attention output (input
    feeding), dropout after each; Luong attention over the encoder
    outputs (keys ``input_proj(outputs)``, made once a batch; the padding
    masked by -1e9), ``tanh(output_proj([context, h]))``; an output
    projection without bias. Every weight uniform in ±``init_scale``."""
    nn = paddle.nn
    F = nn.functional

    def uni():
        return paddle.ParamAttr(initializer=nn.initializer.Uniform(
            -init_scale, init_scale))

    def lstm_attrs():
        return {"weight_ih_attr": uni(), "weight_hh_attr": uni(),
                "bias_ih_attr": uni(), "bias_hh_attr": uni()}

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(hidden, hidden, weight_attr=uni(),
                                        bias_attr=False)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         weight_attr=uni(), bias_attr=False)

        def forward(self, h, keys, mask):
            scores = paddle.matmul(paddle.unsqueeze(h, [1]), keys,
                                   transpose_y=True) + mask
            ctx = paddle.matmul(F.softmax(scores, axis=-1), keys)
            return paddle.tanh(self.output_proj(
                paddle.concat([paddle.squeeze(ctx, [1]), h], 1)))

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.dropout = nn.Dropout(dropout)
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden,
                            **lstm_attrs()) for i in range(layers)])
            self.attention = Attention()

        def forward(self, step_input, states, keys, mask):
            lstm_states, feed = states
            x = paddle.concat([step_input, feed], 1)
            new = []
            for cell, st in zip(self.lstm_cells, lstm_states):
                out, st = cell(x, st)
                x = self.dropout(out)
                new.append(st)
            out = self.attention(x, keys, mask)
            return out, [new, out]

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedder = nn.Embedding(src_vocab, hidden,
                                             weight_attr=uni())
            self.encoder = nn.LSTM(hidden, hidden, layers, dropout=dropout,
                                   **lstm_attrs())
            self.trg_embedder = nn.Embedding(trg_vocab, hidden,
                                             weight_attr=uni())
            self.cell = DecoderCell()
            self.output_layer = nn.Linear(hidden, trg_vocab,
                                          weight_attr=uni(),
                                          bias_attr=False)

        def encode(self, src, src_len):
            """(keys [B, S, H], the additive mask [B, 1, S], the decoder's
            initial states: each layer's final (h, c) and a zero feed)."""
            out, (h, c) = self.encoder(self.src_embedder(src),
                                       sequence_length=src_len)
            valid = F.sequence_mask(src_len, maxlen=src.shape[1],
                                    dtype="float32")
            mask = paddle.unsqueeze((valid - 1.0) * 1e9, [1])
            states = [[(h[i], c[i]) for i in range(layers)],
                      paddle.zeros([src.shape[0], hidden])]
            return self.cell.attention.input_proj(out), mask, states

        def forward(self, src, src_len, trg):
            keys, mask, states = self.encode(src, src_len)
            emb = self.trg_embedder(trg)
            outs = []
            for t in range(trg.shape[1]):
                out, states = self.cell(emb[:, t], states, keys, mask)
                outs.append(out)
            return self.output_layer(paddle.stack(outs, 1))

    return Seq2Seq()


def seq2seq_loss(paddle, logits, label, trg_len):
    """PaddleNLP's ``CrossEntropyCriterion``: each token's softmax
    cross-entropy, masked by ``sequence_mask``, averaged over the batch
    and summed over time."""
    F = paddle.nn.functional
    cost = F.cross_entropy(logits, label, reduction="none")
    mask = F.sequence_mask(trg_len, maxlen=label.shape[1], dtype="float32")
    return paddle.sum(paddle.mean(cost * mask, axis=0))


def seq2seq_batch(rng, batch, src_vocab, trg_vocab, maxlen=S2S_MAXLEN,
                  lens=S2S_LENS, full=False):
    """Seeded token ids (no corpus in the repository) at the given
    vocabularies: (src [B, maxlen], src_len, trg_in, label, trg_len), int64;
    lengths uniform in ``lens`` (every row ``maxlen`` long with ``full``),
    padding the end token, ``trg_in`` the label shifted right behind the
    start token."""
    def lengths():
        if full:
            return np.full(batch, maxlen)
        return rng.integers(lens[0], lens[1] + 1, batch)

    src_len, trg_len = lengths(), lengths()
    steps = np.arange(maxlen)
    src = np.where(steps < src_len[:, None],
                   rng.integers(2, src_vocab, (batch, maxlen)), S2S_EOS)
    label = np.where(steps < trg_len[:, None],
                     rng.integers(2, trg_vocab, (batch, maxlen)), S2S_EOS)
    trg = np.concatenate([np.full((batch, 1), S2S_BOS), label[:, :-1]], 1)
    return [a.astype("int64") for a in (src, src_len, trg, label, trg_len)]


def seq2seq_decoder(paddle, model, src, src_len, beam):
    """(``nn.BeamSearchDecoder`` over the model's decoder cell, the
    initial states): the cell closes over the keys and the mask, each
    repeated per beam (``repeat_interleave``, the search's order)."""
    keys, mask, states = model.encode(src, src_len)
    keys = paddle.repeat_interleave(keys, beam, axis=0)
    mask = paddle.repeat_interleave(mask, beam, axis=0)
    decoder = paddle.nn.BeamSearchDecoder(
        lambda x, st: model.cell(x, st, keys, mask), S2S_BOS, S2S_EOS, beam,
        embedding_fn=model.trg_embedder, output_fn=model.output_layer)
    return decoder, states


def seq2seq_decode(paddle, model, src, src_len, beam, max_len):
    """The beam decode of a batch through ``nn.dynamic_decode``:
    (sequences [B, beam, max_len], scores [B, beam], lengths)."""
    decoder, states = seq2seq_decoder(paddle, model, src, src_len, beam)
    return paddle.nn.dynamic_decode(decoder, inits=states,
                                     max_step_num=max_len)


def seq2seq_trainstep_phase(dev, mods, stamp):
    """Phase 45: the full-width seq2seq (S2S) trained on seeded batches of
    128 through jit.TrainStep (Adam 1e-3, ClipGradByGlobalNorm(5),
    FLAGS_fused_optimizer=1, dropout 0.2): first the uncaptured step
    (S2S_WARM steps whose losses are the yardstick, then S2S_EAGER timed
    ones); then from the same weights and generator state the captured
    step: S2S_WARM calls (the first eager, then the capture), the first 3
    losses against the yardstick's, S2S_CALLS per-call steps, S2S_K
    replays with one host read, one profiled replay; then a beam-10,
    256-step decode of one batch with torch's sync debug mode at "error"
    (a host read inside raises), timed and profiled."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    old = paddle.get_flags(["FLAGS_fused_optimizer", "FLAGS_fast_step"])
    paddle.set_flags({"FLAGS_fused_optimizer": 1, "FLAGS_fast_step": 1})
    try:
        return _seq2seq_trainstep(paddle, dev, mods, stamp)
    finally:
        paddle.set_flags(old)


def _seq2seq_trainstep(paddle, dev, mods, stamp):
    paddle.seed(0)
    rng = np.random.default_rng(45)
    batches = [[paddle.to_tensor(a) for a in seq2seq_batch(
        rng, S2S_BATCH, S2S["src_vocab"], S2S["trg_vocab"])]
        for _ in range(3)]
    tokens = [int(b[4].numpy().sum()) for b in batches]
    model = seq2seq_model(paddle, **S2S)
    n_params = sum(p.size for p in model.parameters())
    state = {k: v._data.detach().clone()
             for k, v in model.state_dict().items()}
    gen_state = paddle.get_rng_state()

    def make_opt():
        return paddle.optimizer.Adam(
            learning_rate=S2S_LR, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(S2S_CLIP))

    def loss_fn(run, src, src_len, trg, label, trg_len):
        return seq2seq_loss(paddle, run(src, src_len, trg), label, trg_len)

    _fresh_peak(dev)
    _reset_vision_counts(mods)
    ref = paddle.jit.TrainStep(model, loss_fn, make_opt(), capture=False)
    ref_losses, eager_ms = [], []
    for i in range(S2S_WARM + S2S_EAGER):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_losses.append(float(ref(*batches[i % 3])))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    eager_launches = _vision_counts(mods)
    eager_ms = eager_ms[S2S_WARM:]
    del ref
    model.set_state_dict(state)
    paddle.set_rng_state(gen_state)
    _fresh_peak(dev)
    step = paddle.jit.TrainStep(model, loss_fn, make_opt())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    base_reserved = torch.cuda.memory_reserved(dev)
    _reset_vision_counts(mods)
    t0 = time.perf_counter()
    warm = [float(step(*batches[i % 3])) for i in range(S2S_WARM)]
    warm_s = time.perf_counter() - t0
    # the memory reserved over the warm calls: the graph's private pool
    # (its intermediates freed back into it stay reserved) and what the
    # eager warm-up left cached; "allocated" counts only what is live
    pool_gib = (torch.cuda.memory_reserved(dev) - base_reserved) / 2**30
    held_gib = (torch.cuda.memory_allocated(dev) - base) / 2**30
    call_ms, losses = [], []
    for i in range(S2S_CALLS):
        t0 = time.perf_counter()
        losses.append(float(step(*batches[i % 3])))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(float(step.steps(S2S_K, *batches[0])))
    replay_ms = (time.perf_counter() - t0) / S2S_K * 1e3
    prof = _profiled_step(lambda: step(*batches[0]), replay_ms)
    launches = _vision_counts(mods)
    steps_run = S2S_WARM + S2S_CALLS + S2S_K + 1
    peak = torch.cuda.max_memory_allocated(dev)
    captures = step.captures
    rel_loss = max(abs(a - b) / abs(b)
                   for a, b in zip(warm, ref_losses[:S2S_WARM]))
    del step
    _fresh_peak(dev)

    # the decode: one batch of 128, beam 10, 256 steps, no host read
    model.eval()
    src, src_len = batches[0][0], batches[0][1]

    def decode():
        with paddle.no_grad():
            return seq2seq_decode(paddle, model, src, src_len, S2S_BEAM,
                                  S2S_MAX_OUT)

    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # a host read or a host-to-device write inside the loop raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        seqs, scores, lengths = decode()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    dprof = _profiled_step(decode, decode_ms)
    model.train()
    s, sc, ln = seqs.numpy(), scores.numpy(), lengths.numpy()
    ok = {"losses_finite": all(map(math.isfinite,
                                   warm + losses + ref_losses)),
          "one_capture": captures == 1,
          "first_losses_vs_uncaptured": rel_loss <= S2S_CAPTURE_LOSS_REL,
          "fused_adamw_each_step":
              launches["fused_adamw"] >= steps_run
              and eager_launches["fused_adamw"] >= S2S_WARM + S2S_EAGER,
          "decode_shapes": list(s.shape) == [S2S_BATCH, S2S_BEAM,
                                             S2S_MAX_OUT]
              and list(sc.shape) == [S2S_BATCH, S2S_BEAM],
          "decode_tokens_in_vocab": bool(((s >= 0)
                                          & (s < S2S["trg_vocab"])).all()),
          "decode_scores_best_first": bool(np.isfinite(sc).all()
                                           and (np.diff(sc, axis=1)
                                                <= 0).all()),
          "decode_lengths": bool(((ln >= 1) & (ln <= S2S_MAX_OUT)).all())}
    row = {"phase": "train_paddle_trainstep_seq2seq_attn",
           "model": "PaddleNLP seq2seq_attn, IWSLT'15 en-vi widths",
           "config": dict(S2S), "params": n_params,
           "batch": S2S_BATCH, "padded_len": S2S_MAXLEN,
           "lengths": list(S2S_LENS),
           "target_tokens_per_batch": tokens,
           "optimizer": f"Adam({S2S_LR}) + ClipGradByGlobalNorm({S2S_CLIP}),"
                        f" FLAGS_fused_optimizer=1",
           "eager_step_ms": eager_ms,
           "eager_step_ms_median": float(np.median(eager_ms)),
           "eager_launches": eager_launches,
           "warm_calls": S2S_WARM, "warm_s": warm_s, "call_ms": call_ms,
           "call_ms_median": float(np.median(call_ms)),
           "k": S2S_K, "replay_ms": replay_ms,
           "samples_per_s": S2S_BATCH / replay_ms * 1e3,
           "target_tokens_per_s": float(np.mean(tokens)) / replay_ms * 1e3,
           "per_call_target_tokens_per_s":
               float(np.mean(tokens)) / float(np.median(call_ms)) * 1e3,
           "graph_pool_gib": pool_gib, "allocated_after_capture_gib":
               held_gib, **prof, "captures": captures,
           "peak_mem_gib": peak / 2**30,
           "first_losses": warm, "first_losses_uncaptured":
               ref_losses[:S2S_WARM], "first_loss_rel": rel_loss,
           "tol_loss_rel": S2S_CAPTURE_LOSS_REL, "last_loss": losses[-1],
           "launches": launches, "steps_run": steps_run,
           "decode": {"batch": S2S_BATCH, "beam": S2S_BEAM,
                      "max_step_num": S2S_MAX_OUT,
                      "enqueue_ms": enqueue_ms, "ms": decode_ms,
                      "sentences_per_s": S2S_BATCH / decode_ms * 1e3,
                      "sync_debug_mode": "error",
                      "mean_length": float(ln[:, 0].mean()),
                      **{k: dprof[k] for k in (
                          "profiled_device_ms", "device_idle_share",
                          "profiled_launches", "top_device_items")}},
           "checks": ok, "ok": all(ok.values()), **stamp}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"seq2seq TrainStep phase failed: {ok}")
    return row


def _beam_trace(decoder, states, batch, beam, steps, device):
    """The search of ``nn/decode.py`` re-run plainly on the host over the
    decoder's own step: per step and row, the set of live prefixes and
    the gap between the K-th and (K+1)-th totals; and the final
    sequences and scores."""
    from paddle_tpu_torch.nn.decode import _tree_map, _unwrap_tree

    st = _tree_map(lambda s: s.repeat_interleave(beam, 0),
                   _unwrap_tree(states))
    logprob = np.full((batch, beam), -1e9, np.float32)
    logprob[:, 0] = 0.0
    finished = np.zeros((batch, beam), bool)
    prefixes = [[()] * beam for _ in range(batch)]
    tokens = np.full(batch * beam, S2S_BOS)
    sets, gaps = [], []
    for _ in range(steps):
        lp, new = decoder._step(torch.as_tensor(tokens, device=device), st)
        lp = lp.detach().cpu().numpy().reshape(batch, beam, -1)
        V = lp.shape[-1]
        eos_row = np.full(V, -1e9, np.float32)
        eos_row[S2S_EOS] = 0.0
        lp = np.where(finished[:, :, None], eos_row, lp)
        flat = (logprob[:, :, None] + lp).reshape(batch, beam * V)
        order = np.argsort(-flat, axis=1, kind="stable")[:, :beam + 1]
        gaps.append([float(flat[b, order[b, beam - 1]]
                           - flat[b, order[b, beam]]) for b in range(batch)])
        top = order[:, :beam]
        parent, token = top // V, top % V
        prefixes = [[prefixes[b][parent[b, k]] + (int(token[b, k]),)
                     for k in range(beam)] for b in range(batch)]
        sets.append([frozenset(p) for p in prefixes])
        finished = (np.take_along_axis(finished, parent, 1)
                    | (token == S2S_EOS))
        logprob = np.take_along_axis(flat, top, 1)
        rows = torch.as_tensor((parent + np.arange(batch)[:, None] * beam)
                               .reshape(-1), device=device)
        st = _tree_map(lambda s: s.index_select(0, rows), new)
        tokens = token.reshape(-1)
    return sets, gaps, prefixes, logprob


def seq2seq_check_phase(dev, stamp, card="gpu"):
    """Phase 45b: the S2S model at full width, dropout 0, f32, batch 2,
    on ``card`` and on the CPU port with the same weights: the first
    loss, every parameter's gradient, and a 32-step beam-10 decode of
    both rows through ``nn.dynamic_decode`` (the same sequences, scores
    within S2S_CHECK_TOL; a row whose sequences part must show, at the
    first step where the two searches' live prefixes part, a K-th and
    (K+1)-th total within S2S_CHECK_TOL["tie"] of each other), each
    decode held to a plain host re-run of its search."""
    import paddle_tpu_torch as paddle

    t_phase = time.perf_counter()
    cfg = dict(S2S, dropout=0.0)
    arrays = seq2seq_batch(np.random.default_rng(451), S2S_CHECK_BATCH,
                           S2S["src_vocab"], S2S["trg_vocab"])
    out = []
    state = None
    try:
        for where in ("cpu", card):
            paddle.set_device(where)
            paddle.seed(0)
            model = seq2seq_model(paddle, **cfg)
            if state is None:
                state = {k: v.numpy() for k, v in model.state_dict().items()}
            model.set_state_dict(state)
            ts = [paddle.to_tensor(a) for a in arrays]
            loss = seq2seq_loss(paddle, model(*ts[:3]), ts[3], ts[4])
            loss.backward()
            grads = {k: p.grad._data.detach().cpu()
                     for k, p in model.named_parameters()}
            model.eval()
            with paddle.no_grad():
                seqs, scores, _ = seq2seq_decode(
                    paddle, model, ts[0], ts[1], S2S_BEAM, S2S_CHECK_STEPS)
                decoder, states = seq2seq_decoder(paddle, model, ts[0],
                                                  ts[1], S2S_BEAM)
                trace = _beam_trace(decoder, states, S2S_CHECK_BATCH,
                                    S2S_BEAM, S2S_CHECK_STEPS,
                                    paddle.get_device().replace("gpu",
                                                                "cuda"))
            out.append((float(loss), grads, seqs.numpy(), scores.numpy(),
                        trace))
    finally:
        paddle.set_device(card)
    (l_cpu, g_cpu, s_cpu, sc_cpu, tr_cpu), (l_dev, g_dev, s_dev, sc_dev,
                                            tr_dev) = out
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    grad_err = {k: _rel(g_dev[k], g_cpu[k]) for k in g_cpu}
    rows, bad = [], []
    for b in range(S2S_CHECK_BATCH):
        # each decode against its own plain re-run (sets: the order of
        # equal totals is free)
        for name, s, tr in (("cpu", s_cpu, tr_cpu), (card, s_dev, tr_dev)):
            if set(map(tuple, s[b])) != set(tr[2][b]):
                bad.append((b, name, "dynamic_decode vs plain search"))
        same = set(map(tuple, s_dev[b])) == set(map(tuple, s_cpu[b]))
        score_err = float(np.abs(np.sort(sc_dev[b]) - np.sort(sc_cpu[b]))
                          .max())
        row = {"row": b, "same_sequences": same, "max_score_err": score_err}
        if same:
            if score_err > S2S_CHECK_TOL["score"]:
                bad.append((b, "scores", score_err))
        else:
            t = next(t for t in range(S2S_CHECK_STEPS)
                     if tr_cpu[0][t][b] != tr_dev[0][t][b])
            gap = min(tr_cpu[1][t][b], tr_dev[1][t][b])
            row.update(parted_at_step=t, kth_gap=gap)
            if gap > S2S_CHECK_TOL["tie"]:
                bad.append((b, "parted without a near tie", t, gap))
        rows.append(row)
    ok = {"loss": loss_rel <= S2S_CHECK_TOL["loss"],
          "grads": max(grad_err.values()) <= S2S_CHECK_TOL["grad"],
          "decode": not bad}
    worst = max(grad_err, key=grad_err.get)
    result = {"phase": "seq2seq_attn_card_vs_cpu", "config": cfg,
              "batch": S2S_CHECK_BATCH, "beam": S2S_BEAM,
              "decode_steps": S2S_CHECK_STEPS, "loss_cpu": l_cpu,
              "loss_card": l_dev, "loss_rel": loss_rel,
              "grad_max_rel": grad_err[worst], "grad_worst_leaf": worst,
              "grads_compared": len(grad_err), "decode_rows": rows,
              "failures": bad, "tol": S2S_CHECK_TOL,
              "seconds": time.perf_counter() - t_phase, "checks": ok,
              "ok": all(ok.values()), **stamp}
    emit(result)
    if not result["ok"]:
        raise AssertionError(f"seq2seq card-vs-CPU check failed: {ok} "
                             f"{bad}")
    return result


# phase 46: the rest of paddle.nn, card against CPU in f32 at realistic
# sizes, as max |d| / max |CPU|: elementwise 1e-5, anything that sums
# (convolutions, norms, losses, recurrences, attention) 1e-4; index
# outputs (pool masks, unpooled planes, decoded tokens) exactly; the
# Transformer decoder's 32-step incremental decode through gen_cache
# against its full causal pass, on each device; the random functions'
# means and variances on 10^6 draws within 5 standard errors, and their
# draws repeated after paddle.seed
SLICE_TOL = {"elem": 1e-5, "reduce": 1e-4, "incremental": 1e-5,
             "moment_se": 5.0}
SLICE_IMAGE = (8, 64, 56, 56)
SLICE_POOL = (8, 64, 112, 112)
SLICE_RNN = (16, 32, 512)            # batch, steps, width
SLICE_CTC = (100, 16, 30, 30)        # T, B, classes, label length
SLICE_TRANSFORMER = {"d_model": 512, "nhead": 8, "layers": 6,
                     "dim_feedforward": 2048, "batch": 2, "tgt": 32,
                     "memory": 64}
SLICE_DRAWS = 10**6


def _seeded_weights(layer, seed):
    """Give ``layer`` numpy weights from ``seed`` (in state_dict order,
    N(0, 0.05²), around 1 for a norm's 1-d ``weight``: a scale near 0
    would shrink each normalized activation and let the next norm's
    backward amplify rounding) on its own device, so the card's and the
    CPU's layers hold the same numbers."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in layer.state_dict().items():
        w = rng.normal(size=v.shape) * 0.05
        if k.endswith("weight") and len(v.shape) == 1:
            w += 1.0
        state[k] = w.astype("float32")
    layer.set_state_dict(state)
    return layer


def _slice_cases():
    """(name, the names it covers, fn(paddle, *tensors), numpy inputs,
    kind, differentiable), phase 44's format, for phase 46."""
    rng = np.random.default_rng(46)
    f32 = lambda *s: rng.normal(size=s).astype("float32")  # noqa: E731
    img = f32(*SLICE_IMAGE)
    cases = []

    def add(name, fn, arrays, kind="reduce", grad=False, covers=None):
        cases.append((name, covers or (name,), fn, arrays, kind, grad))

    # transposed convolutions (the 2-d one at the issue's size)
    add("conv2d_transpose", lambda p, x, w, b: p.nn.functional
        .conv2d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
        [img, f32(64, 128, 3, 3) * 0.05, f32(128)], grad=True)
    add("conv1d_transpose", lambda p, x, w: p.nn.functional
        .conv1d_transpose(x, w, stride=2, padding=[0, 1], groups=2,
                          dilation=2), [f32(4, 16, 40), f32(16, 8, 3)],
        grad=True)
    add("conv3d_transpose", lambda p, x, w: p.nn.functional
        .conv3d_transpose(x, w, stride=2, padding=1, output_size=[16, 16,
                                                                  16]),
        [f32(2, 8, 8, 8, 8), f32(8, 4, 3, 3, 3)], grad=True)
    for n, shape in (("Conv1DTranspose", (4, 16, 40)),
                     ("Conv2DTranspose", (4, 16, 20, 20)),
                     ("Conv3DTranspose", (2, 16, 6, 6, 6))):
        add(n, (lambda n: lambda p, x: _seeded_weights(
            getattr(p.nn, n)(16, 8, 3, stride=2, padding=1), 46)(x))(n),
            [f32(*shape)], grad=True)
    # pooling masks and unpooling, exactly
    pool_x = f32(*SLICE_POOL)
    add("max_pool2d_mask", lambda p, x: p.nn.functional.max_pool2d(
        x, 3, 2, 1, return_mask=True)[1], [pool_x], "index",
        covers=("max_pool2d",))
    add("max_pool2d_mask_ceil", lambda p, x: p.nn.functional.max_pool2d(
        x, 3, 2, 0, ceil_mode=True, return_mask=True)[1], [pool_x],
        "index")
    add("max_unpool2d", lambda p, x: p.nn.functional.max_unpool2d(
        *p.nn.functional.max_pool2d(x, 2, 2, return_mask=True), 2, 2),
        [pool_x], "index")
    add("max_pool1d_mask", lambda p, x: p.nn.functional.max_pool1d(
        x, 4, 3, 1, return_mask=True, ceil_mode=True)[1],
        [f32(8, 64, 1000)], "index", covers=("max_pool1d",))
    add("max_pool3d_mask", lambda p, x: p.nn.functional.max_pool3d(
        x, 3, 2, 1, return_mask=True)[1], [f32(2, 16, 20, 20, 20)],
        "index", covers=("max_pool3d",))
    for n, shape in (("adaptive_max_pool1d", (8, 64, 1000)),
                     ("adaptive_max_pool2d", (8, 64, 56, 56)),
                     ("adaptive_max_pool3d", (2, 16, 20, 20, 20))):
        add(n + "_mask", (lambda n: lambda p, x: getattr(
            p.nn.functional, n)(x, 7, return_mask=True)[1])(n),
            [f32(*shape)], "index", covers=(n,))
    # the other norms
    add("group_norm", lambda p, x, w, b: p.nn.functional.group_norm(
        x, 32, weight=w, bias=b), [img, f32(64), f32(64)], grad=True)
    add("instance_norm", lambda p, x, w, b: p.nn.functional.instance_norm(
        x, weight=w, bias=b), [img, f32(64), f32(64)], grad=True)
    add("local_response_norm", lambda p, x: p.nn.functional
        .local_response_norm(x, 5), [img], grad=True)
    for n, shape in (("GroupNorm", None), ("InstanceNorm1D", (8, 64, 300)),
                     ("InstanceNorm2D", SLICE_IMAGE),
                     ("InstanceNorm3D", (2, 64, 10, 10, 10)),
                     ("LocalResponseNorm", SLICE_IMAGE)):
        make = {"GroupNorm": lambda p: p.nn.GroupNorm(32, 64),
                "LocalResponseNorm": lambda p: p.nn.LocalResponseNorm(5)}.get(
            n, (lambda n: lambda p: getattr(p.nn, n)(64))(n))
        add(n, (lambda make: lambda p, x: _seeded_weights(make(p), 46)(x))(
            make), [img if shape is None else f32(*shape)], grad=True)
    add("SpectralNorm", lambda p, w: _seeded_weights(
        p.nn.SpectralNorm([128, 64, 3, 3], power_iters=2), 46)(w),
        [f32(128, 64, 3, 3)], grad=True)
    # losses
    B, D = 256, 128
    a, pos, neg = f32(B, D), f32(B, D), f32(B, D)
    sign = np.where(rng.uniform(size=B) < 0.5, -1.0, 1.0).astype("float32")
    prob = rng.uniform(0.05, 0.95, (B, 10)).astype("float32")
    lab10 = rng.integers(0, 10, (B, 1)).astype("int64")
    L = lambda n: (lambda p, *t: getattr(p.nn.functional, n)(*t))  # noqa: E731
    add("softmax_with_cross_entropy", L("softmax_with_cross_entropy"),
        [f32(B, 1000), rng.integers(0, 1000, (B, 1)).astype("int64")],
        grad=True)
    add("margin_ranking_loss", L("margin_ranking_loss"),
        [f32(B), f32(B), sign], grad=True)
    add("hinge_embedding_loss", L("hinge_embedding_loss"), [f32(B), sign],
        grad=True)
    add("cosine_embedding_loss", L("cosine_embedding_loss"),
        [a, pos, sign], grad=True)
    add("log_loss", L("log_loss"), [prob, (prob > 0.5).astype("float32")],
        grad=True)
    add("sigmoid_focal_loss", L("sigmoid_focal_loss"),
        [f32(B, 10), (prob > 0.5).astype("float32")], grad=True)
    add("dice_loss", lambda p, x, y: p.nn.functional.dice_loss(
        p.nn.functional.softmax(x), y), [f32(B, 10), lab10], grad=True)
    add("npair_loss", L("npair_loss"),
        [a, pos, rng.integers(0, 20, (B,)).astype("int64")], grad=True)
    add("triplet_margin_loss", L("triplet_margin_loss"), [a, pos, neg],
        grad=True)
    add("margin_cross_entropy", lambda p, x, y: p.nn.functional
        .margin_cross_entropy(x, y), [np.tanh(f32(B, 1000)),
                                      rng.integers(0, 1000, (B,))
                                      .astype("int64")], grad=True)
    add("hsigmoid_loss", lambda p, x, y, w, b: p.nn.functional
        .hsigmoid_loss(x, y, 1000, w, b), [a, rng.integers(
            0, 1000, (B,)).astype("int64"), f32(999, D) * 0.1,
            f32(999) * 0.1], grad=True)
    T, Bc, C, Lc = SLICE_CTC
    ctc_lens = rng.integers(Lc // 2, Lc + 1, Bc).astype("int64")
    ctc_in = [np.log(np.exp(f32(T, Bc, C)) / np.exp(f32(T, Bc, C)).sum(
        -1, keepdims=True)).astype("float32"),
        rng.integers(1, C, (Bc, Lc)).astype("int64"),
        rng.integers(T - 20, T + 1, Bc).astype("int64"), ctc_lens]
    add("ctc_loss", L("ctc_loss"), ctc_in, grad=True)
    path_table = rng.integers(-1, 999, (B, 12)).astype("int64")
    path_table[:, 0] = rng.integers(0, 999, B)
    path_code = rng.integers(0, 2, (B, 12)).astype("int64")
    layers = {
        "MarginRankingLoss": ([f32(B), f32(B), sign], lambda p: p.nn
                              .MarginRankingLoss(0.1)),
        "HingeEmbeddingLoss": ([f32(B), sign], lambda p: p.nn
                               .HingeEmbeddingLoss()),
        "CosineEmbeddingLoss": ([a, pos, sign], lambda p: p.nn
                                .CosineEmbeddingLoss(0.2)),
        "TripletMarginLoss": ([a, pos, neg], lambda p: p.nn
                              .TripletMarginLoss(swap=True)),
        "CTCLoss": (ctc_in, lambda p: p.nn.CTCLoss(reduction="sum")),
        "HSigmoidLoss": ([a, rng.integers(0, 1000, (B,)).astype("int64"),
                          path_table, path_code],
                         lambda p: _seeded_weights(p.nn.HSigmoidLoss(
                             D, 1000, is_custom=True), 46))}
    for n, (arrays, make) in layers.items():
        add(n, (lambda make: lambda p, *t: make(p)(*t))(make), arrays,
            grad=True)
    # recurrent layers at 512
    Br, Tr, H = SLICE_RNN
    seq_x = f32(Br, Tr, H)
    seq_len = rng.integers(Tr // 2, Tr + 1, Br).astype("int64")
    for n, make in (
            ("GRU", lambda p: p.nn.GRU(H, H, 2, direction="bidirect")),
            ("LSTM", lambda p: p.nn.LSTM(H, H, 2)),
            ("SimpleRNN", lambda p: p.nn.SimpleRNN(H, H, 1,
                                                   activation="relu")),
            ("BiRNN", lambda p: p.nn.BiRNN(p.nn.GRUCell(H, H),
                                           p.nn.GRUCell(H, H))),
            ("RNN", lambda p: p.nn.RNN(p.nn.LSTMCell(H, H),
                                       is_reverse=True))):
        add(n, (lambda make: lambda p, x, sl: _seeded_weights(make(p), 46)(
            x, sequence_length=sl)[0])(make), [seq_x, seq_len], grad=True,
            covers=(n, "GRUCell", "LSTMCell") if n in ("BiRNN", "RNN")
            else (n,))
    for n in ("SimpleRNNCell", "LSTMCell", "GRUCell"):
        add(n + "_step", (lambda n: lambda p, x: _seeded_weights(
            getattr(p.nn, n)(H, H), 46)(x)[0])(n), [f32(Br, H)], grad=True,
            covers=(n, "RNNCellBase"))
    # the Transformer decoder stack and the whole Transformer
    tc = SLICE_TRANSFORMER
    tgt, mem = f32(tc["batch"], tc["tgt"], 512), f32(tc["batch"],
                                                     tc["memory"], 512)
    # a bool mask (True = attend): no gradient flows into it
    causal = np.tril(np.ones((tc["tgt"], tc["tgt"]), bool))

    def decoder(p):
        return _seeded_weights(p.nn.TransformerDecoder(
            p.nn.TransformerDecoderLayer(512, 8, 2048, dropout=0.0),
            tc["layers"]), 46)

    add("TransformerDecoder", lambda p, t, m, c: decoder(p)(t, m, c),
        [tgt, mem, causal], grad=True,
        covers=("TransformerDecoder", "TransformerDecoderLayer"))
    add("Transformer", lambda p, s, t, c: _seeded_weights(p.nn.Transformer(
        512, 8, 2, 2, 2048, dropout=0.0), 46)(s, t, tgt_mask=c),
        [mem, tgt, causal], grad=True)
    # the extension and sequence functions
    add("diag_embed", L("diag_embed"), [f32(64, 100)], "elem", True)
    ids = rng.integers(0, 50, (20, 16, 4)).astype("int64")
    parents = rng.integers(0, 4, (20, 16, 4)).astype("int64")
    add("gather_tree", L("gather_tree"), [ids, parents], "index")
    add("temporal_shift", lambda p, x: p.nn.functional.temporal_shift(
        x, 8), [img], "elem", True)
    offs = np.sort(rng.integers(0, 33, (2, 4, 33)), -1)
    offs[..., 0] = 0
    cols = np.stack([np.stack([np.concatenate([rng.permutation(32)[:n]
                                               for n in np.diff(o)]
                                              + [np.zeros(32 * 32 - o[-1],
                                                          int)])
                               for o in ob]) for ob in offs])
    add("sparse_attention", lambda p, q, k, v, o, c: p.nn.functional
        .sparse_attention(q, k, v, o, c), [f32(2, 4, 32, 64),
                                           f32(2, 4, 32, 64),
                                           f32(2, 4, 32, 64),
                                           offs.astype("int64"),
                                           cols.astype("int64")], grad=True)
    lens = rng.integers(1, 40, 64).astype("int64")
    sx = f32(64, 40, 32)
    S = lambda n, *kw: (lambda p, *t: getattr(p.nn.functional, n)(*t))  # noqa: E731
    add("sequence_mask", lambda p, n: p.nn.functional.sequence_mask(
        n, maxlen=40), [lens], "index")
    add("sequence_reverse", S("sequence_reverse"), [sx, lens], "elem", True)
    add("sequence_softmax", S("sequence_softmax"), [sx[..., 0], lens],
        "elem", True)
    for pool in ("sum", "average", "sqrt", "max", "first", "last"):
        add("sequence_pool_" + pool, (lambda pool: lambda p, x, n: p.nn
            .functional.sequence_pool(x, n, pool))(pool), [sx, lens],
            "reduce", True, covers=("sequence_pool",))
    add("sequence_first_step", S("sequence_first_step"), [sx, lens], "elem")
    add("sequence_last_step", S("sequence_last_step"), [sx, lens], "elem")
    add("sequence_expand", S("sequence_expand"), [sx[:8], lens[:8]], "elem",
        covers=("sequence_expand", "sequence_expand_as"))
    add("sequence_enumerate", lambda p, x: p.nn.functional
        .sequence_enumerate(x, 3), [ids[:, :, 0]], "index")
    add("sequence_conv", lambda p, x, n, w: p.nn.functional.sequence_conv(
        x, n, w), [sx, lens, f32(96, 16)], "reduce", True)
    add("sequence_reshape", lambda p, x, n: p.nn.functional
        .sequence_reshape(x, n * 2, 16)[0], [sx, lens], "elem")
    add("sequence_scatter", S("sequence_scatter"),
        [f32(100, 8), rng.integers(0, 100, (16, 6)).astype("int64"),
         f32(16, 6, 8), rng.integers(1, 7, 16).astype("int64")], "reduce")
    add("sequence_slice", lambda p, x, o, n: p.nn.functional
        .sequence_slice(x, o, n)[0], [sx, np.zeros(64, "int64"),
                                      np.minimum(lens, 20)], "elem")
    add("sequence_concat", lambda p, x, y, n, m: p.nn.functional
        .sequence_concat([x, y], [n, m])[0], [sx[:8], sx[8:16], lens[:8],
                                              lens[8:16]], "elem")
    add("sequence_pad", lambda p, x, y: p.nn.functional.sequence_pad(
        [x, y], 0.0)[0], [sx[0, :7], sx[1, :12]], "elem",
        covers=("sequence_pad", "sequence_unpad"))
    add("edit_distance", lambda p, h, r: p.nn.functional.edit_distance(
        h, r)[0], [rng.integers(0, 5, (64, 30)).astype("int64"),
                   rng.integers(0, 5, (64, 25)).astype("int64")], "reduce")

    add("PyLayer", lambda p, x: _cube(p).apply(x), [f32(256, 256)],
        "elem", True)
    # beam search over a GRU cell: tokens and lengths exactly
    V = 64
    add("dynamic_decode", lambda p, h: _decode_case(p, h, V),
        [f32(16, 32)], "index", covers=("BeamSearchDecoder",
                                        "dynamic_decode", "beam_search"))
    return cases


def _cube(p):
    """A PyLayer: x³ with its own backward."""
    class Cube(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensor
            return 3.0 * x * x * g
    return Cube


def _decode_case(p, h, V):
    cell = _seeded_weights(p.nn.GRUCell(32, 32), 46)
    emb = _seeded_weights(p.nn.Embedding(V, 32), 47)
    proj = _seeded_weights(p.nn.Linear(32, V), 48)
    for layer in (emb, proj):
        with p.no_grad():
            for w in layer.parameters():
                w.set_value(w * 40.0)            # peaked: no near ties
    dec = p.nn.BeamSearchDecoder(cell, 0, 1, 4, embedding_fn=emb,
                                 output_fn=proj)
    seqs, scores, lengths = p.nn.dynamic_decode(dec, inits=h,
                                                max_step_num=12)
    return seqs, lengths


def _random_checks(paddle, card):
    """Each random function on ``card``: SLICE_DRAWS draws' mean and
    variance within SLICE_TOL["moment_se"] standard errors of the
    distribution's (the variance's standard error from its fourth
    moment), and the same draws after paddle.seed; randperm and
    multinomial without replacement distinct."""
    n = SLICE_DRAWS
    se = SLICE_TOL["moment_se"]
    pr = paddle.to_tensor(np.full(n, 0.3, "float32"))
    lam = paddle.to_tensor(np.full(n, 4.0, "float32"))
    # name: (draw, mean, variance, fourth central moment)
    dists = {
        "rand": (lambda: paddle.rand([n]), 0.5, 1 / 12, 1 / 80),
        "randn": (lambda: paddle.randn([n]), 0.0, 1.0, 3.0),
        "standard_normal": (lambda: paddle.standard_normal([n]), 0.0, 1.0,
                            3.0),
        "uniform": (lambda: paddle.uniform([n], min=-2.0, max=2.0), 0.0,
                    4 / 3, 16 / 5),
        "normal": (lambda: paddle.normal(1.0, 2.0, [n]), 1.0, 4.0, 48.0),
        "randint": (lambda: paddle.randint(0, 10, [n]), 4.5, 8.25,
                    120.8625),
        "randint_like": (lambda: paddle.randint_like(lam, 0, 10), 4.5, 8.25,
                         120.8625),
        "bernoulli": (lambda: paddle.bernoulli(pr), 0.3, 0.21,
                      0.21 * (1 - 3 * 0.21)),
        "poisson": (lambda: paddle.poisson(lam), 4.0, 4.0, 4.0 + 3 * 16.0),
        "uniform_": (lambda: paddle.uniform_(paddle.zeros([n]), 0.0, 1.0),
                     0.5, 1 / 12, 1 / 80),
        "normal_": (lambda: paddle.normal_(paddle.zeros([n]), 0.0, 1.0),
                    0.0, 1.0, 3.0),
        "exponential_": (lambda: paddle.exponential_(paddle.zeros([n]),
                                                     2.0), 0.5, 0.25,
                         9 / 16)}
    bad, worst = [], {"mean_se": 0.0, "var_se": 0.0}
    for name, (draw, mu, var, m4) in dists.items():
        paddle.seed(4600)
        x = draw()
        paddle.seed(4600)
        y = draw()
        xd = x._data.double()
        if x.place.type != torch.device(card.replace("gpu", "cuda")).type:
            bad.append((name, "device"))
        if not torch.equal(x._data, y._data):
            bad.append((name, "not repeated after paddle.seed"))
        m_se = abs(xd.mean().item() - mu) / math.sqrt(var / n)
        v_se = abs(xd.var().item() - var) / math.sqrt((m4 - var * var) / n)
        worst["mean_se"] = max(worst["mean_se"], m_se)
        worst["var_se"] = max(worst["var_se"], v_se)
        if m_se > se or v_se > se:
            bad.append((name, "moments", m_se, v_se))
    paddle.seed(4601)
    perm = paddle.randperm(n).numpy()
    if not np.array_equal(np.sort(perm), np.arange(n)):
        bad.append(("randperm", "not a permutation"))
    w = paddle.to_tensor(np.random.default_rng(46).uniform(
        0.1, 1.0, (64, 1000)).astype("float32"))
    m = paddle.multinomial(w, 50).numpy()
    if any(len(set(r)) != 50 for r in m) or m.min() < 0 or m.max() >= 1000:
        bad.append(("multinomial", "draws without replacement repeat"))
    counts = np.bincount(paddle.multinomial(
        paddle.to_tensor(np.array([0.1, 0.2, 0.3, 0.4], "float32")), n,
        replacement=True).numpy(), minlength=4) / n
    m_se = float(np.max(np.abs(counts - [0.1, 0.2, 0.3, 0.4])
                        / np.sqrt(np.array([0.09, 0.16, 0.21, 0.24]) / n)))
    worst["mean_se"] = max(worst["mean_se"], m_se)
    if m_se > se:
        bad.append(("multinomial", "frequencies", m_se))
    return bad, worst, sorted(dists) + ["randperm", "multinomial"]


def _incremental_check(paddle, where):
    """The Transformer decoder (SLICE_TRANSFORMER, dropout 0) decoding
    ``tgt`` steps one at a time through ``gen_cache`` against its full
    causal pass on ``where``: max |d| / max |full|."""
    tc = SLICE_TRANSFORMER
    paddle.set_device(where)
    rng = np.random.default_rng(461)
    dec = _seeded_weights(paddle.nn.TransformerDecoder(
        paddle.nn.TransformerDecoderLayer(tc["d_model"], tc["nhead"],
                                          tc["dim_feedforward"],
                                          dropout=0.0), tc["layers"]), 46)
    tgt = paddle.to_tensor(rng.normal(size=(tc["batch"], tc["tgt"],
                                            tc["d_model"])).astype("float32"))
    mem = paddle.to_tensor(rng.normal(size=(tc["batch"], tc["memory"],
                                            tc["d_model"])).astype("float32"))
    with paddle.no_grad():
        full = dec(tgt, mem, paddle.nn.Transformer
                   .generate_square_subsequent_mask(tc["tgt"]))
        cache = dec.gen_cache(mem)
        steps = []
        for t in range(tc["tgt"]):
            out, cache = dec(tgt[:, t:t + 1], mem, None, None, cache)
            steps.append(out)
        inc = paddle.concat(steps, 1)
    return _rel(inc._data, full._data)


def slice_sweep_phase(dev, mods, stamp, card="gpu"):
    """Phase 46: every function and layer this slice adds besides phase
    45's path, on ``card`` and on the CPU port from the same numpy inputs
    and the same numpy weights (``_slice_cases``), at SLICE_TOL; the
    Transformer decoder's incremental decode against its full pass on
    both devices; the random functions on ``card`` (``_random_checks``).
    A name of this slice no case covers fails. The hand-written kernels'
    launches are counted (none is expected: every attention here is
    masked or shorter than the flash threshold)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn.functional import extension, sequence
    from paddle_tpu_torch.nn.layer import rnn, transformer
    from paddle_tpu_torch.tensor import random as trandom

    want = (set(extension.__all__) | set(sequence.__all__)
            | set(rnn.__all__) | set(trandom.__all__)
            | set(SLICE_NAMES) | {"PyLayer", "BeamSearchDecoder",
                                  "dynamic_decode", "beam_search"}
            | (set(transformer.__all__) - {
                "MultiHeadAttention", "TransformerEncoderLayer",
                "TransformerEncoder"}))
    cases = _slice_cases()
    t_phase = time.perf_counter()
    worst = {"elem": (0.0, None), "reduce": (0.0, None),
             "grad": (0.0, None)}
    bad, n_grads = [], 0
    _reset_vision_counts(mods)
    try:
        for name, covers, fn, arrays, kind, grad in cases:
            paddle.seed(46)
            c_outs, c_grads = _sweep_run(paddle, card, fn, arrays, grad)
            paddle.seed(46)
            h_outs, h_grads = _sweep_run(paddle, "cpu", fn, arrays, grad)
            tol = SLICE_TOL["elem" if kind == "elem" else "reduce"]
            for c, h in zip(c_outs, h_outs):
                if c.dtype != h.dtype or c.shape != h.shape:
                    bad.append((name, "dtype or shape"))
                    continue
                err, equal = _sweep_err(kind, c, h)
                if kind == "index" and (err or not equal):
                    bad.append((name, "index outputs differ"))
                elif err > tol:
                    bad.append((name, "values", err))
                if kind != "index" and err > worst[kind][0]:
                    worst[kind] = (err, name)
            for c, h in zip(c_grads, h_grads):
                n_grads += 1
                if (c is None) != (h is None):
                    bad.append((name, "gradient missing"))
                    continue
                if c is None:
                    continue
                err = _rel(c._data.cpu(), h._data)
                if err > tol:
                    bad.append((name, "gradient", err))
                if err > worst["grad"][0]:
                    worst["grad"] = (err, name)
        launches = _vision_counts(mods)
        inc = {w: _incremental_check(paddle, w) for w in (card, "cpu")}
        for w, e in inc.items():
            if e > SLICE_TOL["incremental"]:
                bad.append(("incremental decode", w, e))
        paddle.set_device(card)
        rbad, rworst, rcovered = _random_checks(paddle, card)
        bad += rbad
    finally:
        paddle.set_device(card)
    covered = {n for _, cov, *_ in cases for n in cov} | set(rcovered)
    missing = sorted(want - covered)
    row = {"phase": "paddle_nn_rest_card_vs_cpu",
           "names_swept": len(want & covered), "names_new": len(want),
           "cases": len(cases), "gradients_compared": n_grads,
           "missing": missing, "failures": bad[:20],
           "worst_err": {k: {"err": v[0], "case": v[1]}
                         for k, v in worst.items()},
           "incremental_vs_full": inc, "random_worst_se": rworst,
           "launches": launches, "tol": SLICE_TOL,
           "shapes": {"image": list(SLICE_IMAGE), "pool": list(SLICE_POOL),
                      "rnn": list(SLICE_RNN), "ctc": list(SLICE_CTC),
                      "transformer": SLICE_TRANSFORMER,
                      "draws": SLICE_DRAWS},
           "seconds": time.perf_counter() - t_phase,
           "ok": not bad and not missing, **stamp}
    emit(row)
    print(f"paddle.nn sweep: {row['names_swept']} names in {len(cases)} "
          f"cases, worst errors {row['worst_err']}, incremental "
          f"{inc}, random {rworst}, {row['seconds']:.1f} s", flush=True)
    if not row["ok"]:
        raise AssertionError(f"paddle.nn sweep failed: {bad[:20]} missing "
                             f"{missing}")
    return row


# the functions and layers phase 46 must cover besides whole modules
SLICE_NAMES = (
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose", "max_pool1d",
    "max_pool2d", "max_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "max_unpool2d", "instance_norm", "group_norm",
    "local_response_norm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
    "softmax_with_cross_entropy", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "ctc_loss", "log_loss",
    "sigmoid_focal_loss", "dice_loss", "npair_loss", "triplet_margin_loss",
    "hsigmoid_loss", "margin_cross_entropy", "MarginRankingLoss",
    "HingeEmbeddingLoss", "CosineEmbeddingLoss", "CTCLoss",
    "TripletMarginLoss", "HSigmoidLoss")


# --------------------------------------------------------------------------
# phases 39-40: the cross-host serving fleet
# --------------------------------------------------------------------------

# phase 39: bench.py's _fleet_burst mix (prompt lengths, greedy / sampled
# interleave, Poisson arrivals, new tokens) over one prefill-role and two
# decode-role hosts; leg (b)'s partition window between the router and
# one decode host (bench.py's chaos leg); leg (c)'s cold prompt for the
# first-block against stop-and-copy comparison
FLEET_N = 12
FLEET_LENS = (40, 72, 24, 56)
FLEET_RPS = 24.0
FLEET_NEW = 16
FLEET_SAMPLED = {"temperature": 0.7, "top_k": 5}
FLEET_HOSTS = (("prefill0", "prefill"), ("decode0", "decode"),
               ("decode1", "decode"))
FLEET_PARTITION = "net_partition@step=6:secs=1.5:hosts=router|decode0"
FLEET_COLD = 1500
# phase 40: text prompts posted to /v1/completions, new tokens each
FLEET_PROC_N = 6
FLEET_PROC_NEW = 16


def _fleet_mix(V, seed=1901):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, V, FLEET_LENS[i % len(FLEET_LENS)])
               .astype(np.int32) for i in range(FLEET_N)]
    sample_kw = [{} if i % 2 == 0 else dict(FLEET_SAMPLED)
                 for i in range(FLEET_N)]
    gaps = rng.exponential(1 / FLEET_RPS, FLEET_N)
    return prompts, sample_kw, gaps


def _fleet_up(store_dir, job, factory, hosts=FLEET_HOSTS, **connect_kw):
    """HostAgents over real loopback RPC and a FileKVStore registry in
    ``store_dir``, and a FleetRouter over them."""
    from paddle_tpu_torch.distributed import FileKVStore
    from paddle_tpu_torch.serving import HostAgent, connect_fleet

    store = FileKVStore(store_dir)
    agents = {}
    try:
        for host, role in hosts:
            agents[host] = HostAgent(store, job, host, factory, role=role,
                                     heartbeat_s=0.1)
        router = connect_fleet(store, job, min_hosts=len(hosts),
                               registry_ttl=0.9, rpc_timeout=120.0,
                               poll_s=0.2, monitor_poll_s=0.1, **connect_kw)
    except BaseException:
        for a in agents.values():
            a.close()
        raise
    return agents, router


def _fleet_down(agents, router):
    if router is not None:
        router.shutdown(drain=False, timeout=120)
    for a in agents.values():
        a.close()                   # an abruptly closed host's engines too


def _fleet_burst(dev, cfg, params, mods, job, lose_host=False,
                 fault_spec=None):
    """One ``_fleet_burst`` leg (bench.py:1162) on the port, f32: returns
    its row. Every completed stream must equal a monolithic engine's
    (greedy: or part at a near-tie, TIE_REL; sampled: the fleet's rid
    replayed on the monolithic engine), every request must end with a
    finish reason."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor import (get_histogram, hist_delta,
                                          hist_quantile)
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.resilience import configure_faults
    from paddle_tpu_torch.serving import InferenceEngine
    from paddle_tpu_torch.serving.engine import GenerationRequest

    def factory():
        return InferenceEngine(cfg, params, n_slots=4, paged=True,
                               block_size=16, n_blocks=129,
                               prefill_chunk=64, queue_size=4 * FLEET_N,
                               prefix_cache=True, seed=0, device=dev)

    pa = mods["pa"]
    prompts, sample_kw, gaps = _fleet_mix(cfg.vocab_size)
    mono = factory()
    try:
        want = {i: mono.generate(prompts[i], max_new_tokens=FLEET_NEW)
                for i in range(FLEET_N) if not sample_kw[i]}
    finally:
        mono.shutdown(drain=False)
    keys = ("fleet_prefill_routed", "fleet_direct_fallbacks",
            "fleet_kv_transfer_bytes", "fleet_reroutes", "rpc_calls",
            "rpc_errors", "rpc_retries", "fleet_kv_chunks_streamed",
            "router_failovers")
    s0 = {k: stat_get(k) for k in keys}
    kv0 = get_histogram("fleet_kv_transfer_ms").snapshot()
    # breakers stay counted open after their client closed, so the leg
    # reads the gauge's rise over its start
    breaker0 = stat_get("rpc_breaker_state")
    breaker_max = [breaker0]
    agents, router = {}, None
    results, first, reqs = [None] * FLEET_N, [None] * FLEET_N, \
        [None] * FLEET_N
    sub_t = [0.0] * FLEET_N
    lost = None
    with tempfile.TemporaryDirectory() as root:
        try:
            agents, router = _fleet_up(root, job, factory)
            decoders = [agents[h]._engines[0] for h, r in FLEET_HOSTS
                        if r == "decode"]
            if fault_spec:
                configure_faults(fault_spec)   # clean per-peer indices
            stop = threading.Event()

            def watch():
                while not stop.wait(0.02):
                    breaker_max[0] = max(breaker_max[0],
                                         stat_get("rpc_breaker_state"))

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()

            def consume(i, req):
                toks = []
                try:
                    for tok in req.stream(timeout=600):
                        if first[i] is None:
                            first[i] = (time.perf_counter() - sub_t[i]) * 1e3
                        toks.append(tok)
                    results[i] = toks
                except RuntimeError:
                    results[i] = None

            _reset_vision_counts(mods)
            threads = []
            with _ThreadLaunches(pa) as tl:
                t0 = time.perf_counter()
                for i in range(FLEET_N):
                    sub_t[i] = time.perf_counter()
                    reqs[i] = router.submit(prompts[i],
                                            max_new_tokens=FLEET_NEW,
                                            **sample_kw[i])
                    th = threading.Thread(target=consume, args=(i, reqs[i]))
                    th.start()
                    threads.append(th)
                    if lose_host and lost is None and i == FLEET_N // 2:
                        # close the decode host of an open stream: its
                        # streams must reroute token-identically
                        for r in reqs[:i + 1]:
                            rep = getattr(r, "_replica", None)
                            if r.finish_reason is None and rep is not None:
                                host = router.engine_for(rep).host
                                lost = host
                                agents[host].close(abrupt=True)
                                break
                    time.sleep(gaps[i])
                for th in threads:
                    th.join(timeout=900)
                wall = time.perf_counter() - t0
            stop.set()
            watcher.join(timeout=5)
            if any(th.is_alive() for th in threads):
                raise AssertionError("a fleet consumer never finished")
            by_decoder = tl.of(decoders)
            launches = _vision_counts(mods)
            stream = dict(router.last_stream_stats or {})
        finally:
            if fault_spec:
                configure_faults("")
            _fleet_down(agents, router)
    oracle = factory()
    try:
        for i in range(FLEET_N):
            if not sample_kw[i] or results[i] is None:
                continue
            o = GenerationRequest(prompts[i], FLEET_NEW,
                                  sample_kw[i]["temperature"],
                                  sample_kw[i]["top_k"], 1.0, None, None)
            o.rid = reqs[i].rid
            oracle.adopt_request(o)
            want[i] = o.result(timeout=600)
    finally:
        oracle.shutdown(drain=False)
    fin = [r.finish_reason for r in reqs]
    done = [i for i in range(FLEET_N) if results[i] is not None]
    sampled_bad = [i for i in done if sample_kw[i] and results[i] != want[i]]
    greedy = [i for i in done if not sample_kw[i]]
    equal, ties = _streams_equal(G, cfg, params,
                                 [prompts[i] for i in greedy],
                                 [want[i] for i in greedy],
                                 [results[i] for i in greedy], dev)
    d = {k: stat_get(k) - s0[k] for k in keys}
    kv = hist_delta(kv0, get_histogram("fleet_kv_transfer_ms").snapshot())
    row = {"layers": cfg.n_layers, "dtype": str(cfg.dtype),
           "finish_reasons": fin, "completed": len(done),
           "lost_host": lost, "fault_spec": fault_spec,
           "greedy_equal": equal, "near_ties": ties,
           "sampled_equal": sum(1 for i in done if sample_kw[i])
           - len(sampled_bad), "sampled_differ": sampled_bad,
           "first_token": _pcts(first), "wall_s": wall,
           "kv_transfer_ms": {"count": kv["count"],
                              "p50": hist_quantile(kv, 0.5),
                              "p99": hist_quantile(kv, 0.99)},
           "rpc_breaker_state_rise": breaker_max[0] - breaker0,
           "last_stream": stream, "launches": launches,
           "paged_launches_by_decode_host": by_decoder, **d}
    if sampled_bad or any(f is None for f in fin) \
            or len(done) != FLEET_N or any(f != "length" for f in fin) \
            or d["fleet_prefill_routed"] < 1:
        raise AssertionError(f"fleet burst is off: {row}")
    return row


def _cold_stream_vs_copy(dev, src, dst_stream, dst_copy, V):
    """bench.py:1496-1560's comparison on one cold FLEET_COLD-token
    prompt each, engine to engine: the first streamed block spliced into
    a decode engine (chunks ship while the next chunk computes) against a
    whole-prefix stop-and-copy (prefill, export, import). Then the bytes
    of that stop-and-copy payload step by step: the export (card to host,
    on the scheduler thread), the codec's encode and decode, one RPC
    round trip over loopback carrying the payload, the import (host to
    card and the radix splice)."""
    from paddle_tpu_torch.serving import rpc

    rng = np.random.default_rng(1560)
    p_stream, p_copy = (rng.integers(0, V, FLEET_COLD).astype(np.int32)
                        for _ in range(2))
    t0 = time.perf_counter()
    wreq = src.warm_prefix(p_stream)      # non-blocking: chunks compute
    first_block_ms = None
    while time.perf_counter() < t0 + 600:
        exp1 = src.export_kv_range(p_stream, start_block=0, max_blocks=1)
        if exp1["n_blocks"] > 0:
            dst_stream.import_kv_chunk(p_stream, exp1["kb"], exp1["vb"],
                                       int(exp1["start_block"]),
                                       int(exp1["covered_tokens"]))
            first_block_ms = (time.perf_counter() - t0) * 1e3
            break
        time.sleep(0.002)
    wreq.result(timeout=600)
    t0 = time.perf_counter()
    src.warm_prefix(p_copy).result(timeout=600)
    t1 = time.perf_counter()
    exp = src.export_kv_prefix(p_copy)
    t2 = time.perf_counter()
    got = dst_copy.import_kv_prefix(p_copy, exp["kb"], exp["vb"],
                                    exp["matched_len"])
    t3 = time.perf_counter()
    nbytes = exp["kb"].nbytes + exp["vb"].nbytes
    arrays = {"kb": exp["kb"], "vb": exp["vb"]}
    t4 = time.perf_counter()
    manifest, blob = rpc.encode_arrays(arrays)
    t5 = time.perf_counter()
    buf = bytearray(blob)
    t6 = time.perf_counter()
    back = rpc.decode_arrays(manifest, buf)
    t7 = time.perf_counter()
    if back["kb"].dtype != torch.bfloat16 \
            or not torch.equal(back["kb"].view(torch.int16),
                               exp["kb"].view(torch.int16)):
        raise AssertionError("the codec changed a bf16 KV payload")
    del blob, buf, back
    srv = rpc.RpcServer({"sink": lambda p, a: {"bytes": sum(
        v.nbytes for v in a.values())}})
    cli = rpc.RpcClient(srv.addr, timeout=600.0)
    try:
        cli.call("sink", {}, {"x": np.zeros(16, np.float32)})   # dial
        t8 = time.perf_counter()
        res, _ = cli.call("sink", {}, arrays)
        t9 = time.perf_counter()
    finally:
        cli.close()
        srv.close()
    if res["bytes"] != nbytes or got < FLEET_COLD - 1:
        raise AssertionError(f"stop-and-copy payload is off: {res}, {got}")

    def gbs(ms):
        return nbytes / (ms * 1e-3) / 1e9 if ms > 0 else None

    steps = {"export_ms": (t2 - t1) * 1e3, "encode_ms": (t5 - t4) * 1e3,
             "decode_ms": (t7 - t6) * 1e3, "rpc_ms": (t9 - t8) * 1e3,
             "import_ms": (t3 - t2) * 1e3}
    return {"prompt": FLEET_COLD, "first_block_ms": first_block_ms,
            "stop_copy_ms": (t3 - t0) * 1e3,
            "stop_copy_prefill_ms": (t1 - t0) * 1e3,
            "first_block_lt_stop_copy": first_block_ms is not None
            and first_block_ms < (t3 - t0) * 1e3,
            "payload_bytes": nbytes,
            "byte_path": {**steps, **{k.replace("_ms", "_gb_s"): gbs(v)
                                      for k, v in steps.items()}}}


def fleet_phase(dev, cfg, params, mods, stamp, ref_outs=None):
    """Phase 39: the fleet in one process (bench.py:1162 _fleet_burst on
    the port): a prefill-role and two decode-role HostAgents over real
    loopback RPC and a FileKVStore registry in a temp directory,
    connect_fleet, paged prefix-caching engines. (a) f32 at gpt_1p3b's
    width and IDENTITY_LAYERS layers: FLEET_N requests of FLEET_LENS
    tokens, even ones greedy, odd ones sampled, Poisson at FLEET_RPS,
    FLEET_NEW new tokens; one decode host closed abruptly mid-burst;
    every stream completes and equals a monolithic engine's (greedy: or
    parts at a near-tie, TIE_REL), fleet_prefill_routed >= 1,
    fleet_reroutes >= 1. (b) the same under a FLEET_PARTITION window:
    the same gates, and rpc_errors or rpc_breaker_state moved. (c) bf16
    at full depth: phase 5's requests through the disaggregated path,
    submitted one after another (a long prompt's submit returns once its
    KV has streamed; the router places by the decode hosts' load, which
    an in-flight stream does not raise, so concurrent submits would all
    land on one host), each consumed on its own thread: first-token p50
    / p99, fleet_kv_transfer_ms p50 / p99, bytes and GB/s, decode tok/s,
    row 2's launches on each decode host (> 0), the share of greedy
    tokens equal to phase 5's paged streams ``ref_outs`` (reported, not
    gated:
    bf16 sums in another batch can part them); then the first-block
    against stop-and-copy comparison and the stop-and-copy payload's
    byte path (``_cold_stream_vs_copy``)."""
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor import (get_histogram, hist_delta,
                                          hist_quantile)
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    pa = mods["pa"]
    cfg32 = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32)
    p32 = _scaled_params(G, cfg32, dev)
    loss = _fleet_burst(dev, cfg32, p32, mods, "fleet_loss",
                        lose_host=True)
    part = _fleet_burst(dev, cfg32, p32, mods, "fleet_partition",
                        fault_spec=FLEET_PARTITION)
    del p32
    _fresh_peak(dev)
    if loss["fleet_reroutes"] < 1 or loss["lost_host"] is None:
        raise AssertionError(f"fleet host loss rerouted nothing: {loss}")
    if part["rpc_errors"] < 1 and part["rpc_breaker_state_rise"] < 1:
        raise AssertionError(f"fleet partition moved nothing: {part}")

    # (c) bf16, full depth, phase 5's requests
    requests = phase5_requests(cfg.vocab_size)

    def factory():
        return InferenceEngine(cfg, params, n_slots=8, paged=True,
                               prefix_cache=True, seed=5, device=dev)

    keys = ("fleet_prefill_routed", "fleet_direct_fallbacks",
            "fleet_kv_transfer_bytes", "fleet_kv_chunks_streamed",
            "serving_decode_ms")
    n = len(requests)
    first, outs, reqs = [None] * n, [None] * n, [None] * n
    agents, router = {}, None
    with tempfile.TemporaryDirectory() as root:
        try:
            agents, router = _fleet_up(root, "fleet_bf16", factory)
            decoders = [agents[h]._engines[0] for h, r in FLEET_HOSTS
                        if r == "decode"]
            s0 = {k: stat_get(k) for k in keys}
            kv0 = get_histogram("fleet_kv_transfer_ms").snapshot()

            def consume(i, t):
                toks = []
                for tok in reqs[i].stream(timeout=600):
                    if first[i] is None:
                        first[i] = (time.perf_counter() - t) * 1e3
                    toks.append(tok)
                outs[i] = toks

            _reset_vision_counts(mods)
            threads = []
            with _ThreadLaunches(pa) as tl:
                t0 = time.perf_counter()
                # bench.py's shape: the submit of a long prompt returns
                # once its KV has streamed; consumers run meanwhile
                for i, (p, kw) in enumerate(requests):
                    t = time.perf_counter()
                    reqs[i] = router.submit(p, max_new_tokens=FLEET_NEW,
                                            **kw)
                    th = threading.Thread(target=consume, args=(i, t))
                    th.start()
                    threads.append(th)
                for th in threads:
                    th.join(timeout=900)
                wall = time.perf_counter() - t0
            launches = _vision_counts(mods)
            by_decoder = tl.of(decoders)
            if any(th.is_alive() for th in threads) or None in outs:
                raise AssertionError(f"a bf16 fleet stream failed: {outs}")
            d = {k: stat_get(k) - s0[k] for k in keys}
            kv = hist_delta(kv0, get_histogram("fleet_kv_transfer_ms")
                            .snapshot())
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            cold = _cold_stream_vs_copy(
                dev, agents["prefill0"]._engines[0], decoders[0],
                decoders[1], cfg.vocab_size)
        finally:
            _fleet_down(agents, router)
    decode_tokens = sum(len(o) - 1 for o in outs)
    kv_s = kv["sum"] / 1e3
    identity = None
    if ref_outs is not None:
        pairs = [(o, r[:FLEET_NEW]) for (_, kw), o, r in
                 zip(requests, outs, ref_outs) if not kw]
        identity = sum(a == b for o, r in pairs for a, b in zip(o, r)) \
            / max(1, sum(len(r) for _, r in pairs))
    bf16 = {"layers": cfg.n_layers, "dtype": str(cfg.dtype),
            "requests": n, "prompt_lens": [len(p) for p, _ in requests],
            "new_tokens": FLEET_NEW, "wall_s": wall,
            "finish_reasons": [r.finish_reason for r in reqs],
            "first_token": _pcts(first),
            "kv_transfer_ms": {"count": kv["count"],
                               "p50": hist_quantile(kv, 0.5),
                               "p99": hist_quantile(kv, 0.99),
                               "sum": kv["sum"]},
            "kv_transfer_bytes": d["fleet_kv_transfer_bytes"],
            # the streams overlap: bytes over the summed stream ms is the
            # rate one stream saw on average; over the wall, the fleet's
            "kv_gb_s_per_stream": d["fleet_kv_transfer_bytes"] / kv_s / 1e9
            if kv_s > 0 else None,
            "kv_gb_s_wall": d["fleet_kv_transfer_bytes"] / wall / 1e9,
            "greedy_token_identity_vs_phase5": identity,
            "prefill_routed": d["fleet_prefill_routed"],
            "direct_fallbacks": d["fleet_direct_fallbacks"],
            "kv_chunks": d["fleet_kv_chunks_streamed"],
            "decode_tokens": decode_tokens,
            "decode_ms_total": d["serving_decode_ms"],
            "decode_tok_s": decode_tokens
            / max(d["serving_decode_ms"], 1) * 1e3,
            "peak_gib": peak, "launches": launches,
            "paged_launches_by_decode_host": by_decoder,
            "cold_1500": cold}
    row = {"phase": "serving_fleet", "model": "gpt_1p3b",
           "requests": FLEET_N, "prompt_lens": list(FLEET_LENS),
           "rps": FLEET_RPS, "new_tokens": FLEET_NEW,
           "hosts": [h for h, _ in FLEET_HOSTS], "f32_host_loss": loss,
           "f32_partition": part, "bf16": bf16, **stamp}
    emit(row)
    if min(by_decoder) <= 0 or bf16["prefill_routed"] != n \
            or bf16["direct_fallbacks"] \
            or any(f not in ("length", "eos") for f in
                   bf16["finish_reasons"]) \
            or min(loss["paged_launches_by_decode_host"]) <= 0:
        raise AssertionError(f"bf16 fleet run is off: {row}")
    return row


def _fleet_host_proc(root, job, host, role, stop_file, report_file):
    """Phase 40's host process (spawned): one HostAgent over a byte-
    tokenizer f32 engine on the card at gpt_1p3b's width and
    IDENTITY_LAYERS layers, serving until ``stop_file`` appears; then its
    peak memory, kernel launches and whether it found the parent's
    kernel builds go to ``report_file`` and to its own line. Without a
    card it reports that and exits nonzero: a host never falls back to
    the CPU."""
    report = {"host": host, "role": role, "pid": os.getpid()}
    if not torch.cuda.is_available():
        report["error"] = "no CUDA device in the host process"
        with open(report_file, "w") as f:
            json.dump(report, f)
        sys.exit(3)
    from paddle_tpu_torch.distributed import FileKVStore
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (ByteTokenizer, HostAgent,
                                          InferenceEngine)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report["prebuilt"] = all(_build._target(n).exists()
                             for n in _build.SOURCES)
    tok = ByteTokenizer()
    cfg = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32,
                     vocab_size=tok.vocab_size)
    params = _scaled_params(G, cfg, dev)

    def factory():
        return InferenceEngine(cfg, params, n_slots=4, paged=True,
                               block_size=16, n_blocks=129,
                               prefill_chunk=64, prefix_cache=True, seed=0,
                               tokenizer=tok, device=dev)

    torch.cuda.reset_peak_memory_stats(dev)
    agent = HostAgent(FileKVStore(root), job, host, factory, role=role,
                      heartbeat_s=0.2)
    try:
        while not os.path.exists(stop_file):
            time.sleep(0.05)
    finally:
        agent.close()
    report.update(device=torch.cuda.get_device_name(0),
                  engine_device=str(agent._engines[0].device),
                  peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                  paged_launches=pa.LAUNCHES, flash_launches=fa.LAUNCHES)
    with open(report_file, "w") as f:
        json.dump(report, f)
    print(json.dumps({"fleet_host": report}), flush=True)


def fleet_process_phase(dev, stamp):
    """Phase 40: one prefill-role and one decode-role HostAgent, each a
    spawned process on the card (tests/test_serving_fleet.py:625's
    shape); the parent holds a connect_fleet router behind
    ServingFrontend. FLEET_PROC_N text prompts POSTed to /v1/completions
    (SSE) at Poisson gaps: every text equals a monolithic card engine's,
    fleet_prefill_routed > 0; first-token ms over HTTP (after one
    warm-up request, whose own first token is reported apart); each
    host's peak memory and launches from its own report; both hosts on
    the card and loading the parent's kernel builds."""
    import http.client
    import multiprocessing

    from paddle_tpu_torch.distributed import FileKVStore
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import (ByteTokenizer, InferenceEngine,
                                          ServingFrontend, Tenant,
                                          connect_fleet)

    tok = ByteTokenizer()
    cfg = G.gpt_1p3b(n_layers=IDENTITY_LAYERS, dtype=torch.float32,
                     vocab_size=tok.vocab_size)
    params = _scaled_params(G, cfg, dev)
    prompts = [f"request {i}: the quick brown fox number {i} jumps over "
               f"the lazy dog" for i in range(FLEET_PROC_N)]
    mono = InferenceEngine(cfg, params, n_slots=4, paged=True,
                           block_size=16, n_blocks=129, prefill_chunk=64,
                           prefix_cache=True, seed=0, tokenizer=tok,
                           device=dev)
    try:
        want = [mono.submit(text=p, max_new_tokens=FLEET_PROC_NEW)
                .text(timeout=600) for p in prompts]
    finally:
        mono.shutdown(drain=False)
    del params
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    routed0 = stat_get("fleet_prefill_routed")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kv")
        stop_file = os.path.join(tmp, "stop")
        hosts = (("pf", "prefill"), ("dec", "decode"))
        reports = {h: os.path.join(tmp, f"{h}.json") for h, _ in hosts}
        procs = [ctx.Process(target=_fleet_host_proc,
                             args=(root, "procs", h, r, stop_file,
                                   reports[h]))
                 for h, r in hosts]
        t_spawn = time.perf_counter()
        for p in procs:
            p.start()
        router = fe = None
        results = [None] * FLEET_PROC_N
        try:
            deadline = time.perf_counter() + 300.0
            while router is None:
                dead = [p.exitcode for p in procs if p.exitcode is not None]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(f"a fleet host process ended "
                                         f"before serving: {dead}")
                try:
                    router = connect_fleet(FileKVStore(root), "procs",
                                           min_hosts=2, timeout=5.0,
                                           registry_ttl=2.0, poll_s=0.2)
                except TimeoutError:
                    continue
            up_s = time.perf_counter() - t_spawn
            fe = ServingFrontend(router, tenants=[
                Tenant("t", "sk-t", rate=1000, burst=1000)]).start()
            gaps = np.random.default_rng(7).exponential(1 / 20.0,
                                                        FLEET_PROC_N)

            def post(i, prompt=None):
                conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                                  timeout=600)
                try:
                    t0 = time.perf_counter()
                    conn.request("POST", "/v1/completions", json.dumps(
                        {"model": "m",
                         "prompt": prompts[i] if prompt is None else prompt,
                         "max_tokens": FLEET_PROC_NEW, "temperature": 0.0,
                         "stream": True}),
                        {"Authorization": "Bearer sk-t",
                         "Content-Type": "application/json"})
                    resp = conn.getresponse()
                    first_ms, chunks = None, []
                    while True:
                        line = resp.fp.readline()
                        if not line:
                            break
                        if line.startswith(b"data: "):
                            if first_ms is None:
                                first_ms = (time.perf_counter() - t0) * 1e3
                            chunks.append(line[len(b"data: "):].strip())
                    text = "".join(json.loads(c)["choices"][0]["text"]
                                   for c in chunks if c != b"[DONE]")
                    out = (resp.status, text, first_ms)
                    if prompt is None:
                        results[i] = out
                    return out
                finally:
                    conn.close()

            # one request first: the host processes' first prefill,
            # stream and decode start their CUDA libraries
            cold = post(0, "a warm-up request through both hosts")
            threads = []
            for i in range(FLEET_PROC_N):
                th = threading.Thread(target=post, args=(i,))
                th.start()
                threads.append(th)
                time.sleep(float(gaps[i]))
            for th in threads:
                th.join(timeout=600)
        finally:
            with open(stop_file, "w") as f:
                f.write("stop")
            if fe is not None:
                fe.close()
            if router is not None:
                router.shutdown(drain=False, timeout=120)
            for p in procs:
                p.join(timeout=120)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
        host_reports = {}
        for h, path in reports.items():
            with open(path) as f:
                host_reports[h] = json.load(f)
    routed = stat_get("fleet_prefill_routed") - routed0
    row = {"phase": "serving_fleet_processes", "model": "gpt_1p3b",
           "layers": cfg.n_layers, "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype), "prompts": FLEET_PROC_N,
           "new_tokens": FLEET_PROC_NEW, "hosts_up_s": up_s,
           "statuses": [r and r[0] for r in results],
           "texts_equal": sum(1 for r, w in zip(results, want)
                              if r and r[1] == w),
           "first_token_http": _pcts([r and r[2] for r in results]),
           "first_token_http_cold_ms": cold[2], "cold_status": cold[0],
           "prefill_routed": routed, "host_reports": host_reports,
           "exit_codes": [p.exitcode for p in procs], **stamp}
    emit(row)
    if row["texts_equal"] != FLEET_PROC_N or routed <= 0 \
            or any(s != 200 for s in row["statuses"]) \
            or cold[0] != 200 \
            or any(c != 0 for c in row["exit_codes"]) \
            or any("error" in r or not r["prebuilt"]
                   or not r["engine_device"].startswith("cuda")
                   for r in host_reports.values()) \
            or host_reports["dec"]["paged_launches"] <= 0:
        raise AssertionError(f"fleet process run is off: {row}")
    return row


def _kernel(name, source, replaces, launches, row, err, keys, library):
    ms, plain, bnd, by = keys
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": row[ms], "plain_ms": row[plain],
            "bound_ms": row[bnd], "bound_by": row[by],
            "library_ms": row[library] if library else None}


def _batch_keys(row):
    """A phase-3, -7 or -16 row's back-to-back times, for the kernels
    line beside the lone-call "ms" and "library_ms" of every kernel."""
    return {"batch_ms": row["batch_ms"],
            "library_batch_ms": row["library_batch_ms"]}


def _shape_keys(row):
    """A phase-3 or phase-16 row's shape ((B, H, S, D) or (M, K, N)) and
    times, for the kernels line."""
    shape = row["shape"] if "shape" in row else [row[k] for k in "MKN"]
    return {"shape": shape, **{k: row[k] for k in (
        "ms", "batch_ms", "library_ms", "library_batch_ms",
        "ratio_to_library", "batch_ratio_to_library", "bound_ms")}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    t_main = time.perf_counter()
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    name, limit = (x.strip() for x in smi.split(",", 1))
    stamp = {"card": name, "power_limit": limit}
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_device": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for n in _build.SOURCES
             for ln in _build.build_log(n).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas, **hopper_report(_build),
          "int8_kernels": int8_report(_build), **bulk_report(_build)})

    flash = flash_phase(dev, fa, stamp)
    paged = paged_phase(dev, pa, stamp)

    from paddle_tpu_torch.ops import fused_kernels as fk

    cfg = G.gpt_1p3b()
    params = G.gpt_init(cfg, seed=0, device=dev)
    runs = {m: engine_phase(dev, cfg, params, m, fa, pa, stamp)
            for m in (False, True)}
    logits_phase(dev, params, stamp)
    del params
    torch.cuda.empty_cache()

    flash_bwd = flash_bwd_phase(dev, fa, stamp)
    fmlp = fmlp_phase(dev, fk, stamp)
    train = train_phase(dev, fa, fk, stamp)
    grads_phase(dev, stamp)

    from paddle_tpu_torch.ops import fused_optimizer as fo
    from paddle_tpu_torch.ops import int8_matmul as im

    opt = opt_phase(dev, fo, stamp)
    train_f = train_phase(dev, fa, fk, stamp, fo=fo, ref=train)
    lamb = lamb_train_phase(dev, fo, stamp)
    i8 = int8_phase(dev, im, stamp)
    params = G.gpt_init(cfg, seed=0, device=dev)
    runs8 = {m: engine_phase(dev, cfg, params, m, fa, pa, stamp, im=im,
                             int8=True, fp_outs=runs[m]["outs"])
             for m in (False, True)}
    del params
    torch.cuda.empty_cache()
    int8_decode_phase(dev, stamp)

    from paddle_tpu_torch.amp import fp8 as f8
    from paddle_tpu_torch.ops import fp8_matmul as fm
    from paddle_tpu_torch.ops import moe_dispatch as md

    fp8 = fp8_phase(dev, fm, f8, stamp)
    train_fp8 = train_phase(
        dev, fa, fk, stamp, cfg=G.gpt_1p3b(remat=True, fused_mlp=True,
                                           fp8=True),
        extra={"fp8_matmul": fm}, phase="train_fp8", ref=train,
        ref_tol=FP8_TRAIN_LOSS_REL, first_equal=False)
    fp8_check_phase(dev, stamp)
    gather = gather_phase(dev, md, stamp)
    cfg_moe = G.gpt_1p3b(moe_experts=8)
    params = G.gpt_init(cfg_moe, seed=0, device=dev)
    runs_moe = {m: engine_phase(dev, cfg_moe, params, m, fa, pa, stamp,
                                md=md)
                for m in (False, True)}
    del params
    torch.cuda.empty_cache()
    moe_check_phase(dev, stamp)
    train_moe = train_phase(
        dev, fa, fk, stamp, cfg=G.gpt_1p3b(remat=True, fused_mlp=True,
                                           moe_experts=8, n_layers=8),
        extra={"moe_dispatch_gather": md}, phase="train_moe")
    addln = addln_phase(dev, fk, stamp)
    bert = bert_train_phase(dev, fa, fk, fo, stamp)
    bert_check_phase(dev, stamp)

    spec_identity_phase(dev, stamp)
    params = G.gpt_init(cfg, seed=0, device=dev)
    runs_spec = spec_phase(dev, cfg, params, fa, pa, stamp)
    prefix = prefix_phase(dev, cfg, params, fa, pa, stamp)
    text_phase(dev, cfg, params, stamp)
    mods = {"flash_attention_fwd": fa, "paged_attention_decode": pa,
            "int8_matmul": im}
    res_s = {}                         # phases 30-33's seconds each

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        res_s[name] = time.perf_counter() - t
        return out

    with tempfile.TemporaryDirectory() as flight_dir:
        wd = timed("watchdog", watchdog_phase, dev, cfg, params, mods,
                   stamp, flight_dir)
        ov = timed("overload", overload_phase, dev, cfg, params, mods, stamp)
        kv = timed("kv_stream", kv_stream_phase, dev, cfg, params, mods,
                   stamp)
        fo_run = timed("failover", failover_phase, dev, cfg, params, mods,
                       stamp, flight_dir)
    orch_s = {}                        # phases 34-36's seconds each
    t = time.perf_counter()
    chaos = router_chaos_phase(dev, cfg, params, mods, stamp)
    orch_s["router_chaos"] = time.perf_counter() - t
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    life = supervisor_phase(dev, mods, stamp)
    orch_s["supervisor"] = time.perf_counter() - t
    t = time.perf_counter()
    front = frontend_phase(dev, mods, stamp)
    orch_s["frontend"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    vision_mods = {"fa": fa, "pa": pa, "fk": fk, "fo": fo, "im": im,
                   "fm": fm, "md": md}
    vision_s = {}                      # phases 37-38's seconds each
    t = time.perf_counter()
    lenet = lenet_phase(dev, vision_mods, stamp)
    vision_s["lenet"] = time.perf_counter() - t
    t = time.perf_counter()
    resnet = resnet50_phase(dev, vision_mods, stamp)
    vision_s["resnet50"] = time.perf_counter() - t
    t = time.perf_counter()
    resnet50_check_phase(dev, stamp)
    vision_s["resnet50_check"] = time.perf_counter() - t
    fleet_s = {}                       # phases 39-40's seconds each
    t = time.perf_counter()
    params = G.gpt_init(cfg, seed=0, device=dev)
    fleet = fleet_phase(dev, cfg, params, vision_mods, stamp,
                        ref_outs=runs[True]["outs"])
    del params
    _fresh_peak(dev)
    fleet_s["fleet_inprocess"] = time.perf_counter() - t
    t = time.perf_counter()
    fleet_procs = fleet_process_phase(dev, stamp)
    fleet_s["fleet_processes"] = time.perf_counter() - t
    entry_s = {}                       # phases 41-42's seconds each
    t = time.perf_counter()
    lenet_m = lenet_model_phase(dev, vision_mods, stamp,
                                lenet["step_ms_median_last3"])
    entry_s["lenet_model"] = time.perf_counter() - t
    t = time.perf_counter()
    resnet_ts = resnet50_trainstep_phase(dev, vision_mods, stamp,
                                         resnet["step_ms_median_last3"])
    entry_s["resnet50_trainstep"] = time.perf_counter() - t
    surface_s = {}                     # phases 43-44's seconds each
    t = time.perf_counter()
    mobilenet_ts = mobilenet_v2_trainstep_phase(dev, vision_mods, stamp)
    surface_s["mobilenet_v2_trainstep"] = time.perf_counter() - t
    t = time.perf_counter()
    vision_models_check_phase(dev, stamp)
    surface_s["vision_models_check"] = time.perf_counter() - t
    t = time.perf_counter()
    surface_sweep_phase(dev, stamp)
    surface_s["surface_sweep"] = time.perf_counter() - t
    nn_s = {}                          # phases 45-46's seconds each
    t = time.perf_counter()
    s2s = seq2seq_trainstep_phase(dev, vision_mods, stamp)
    nn_s["seq2seq_trainstep"] = time.perf_counter() - t
    t = time.perf_counter()
    seq2seq_check_phase(dev, stamp)
    nn_s["seq2seq_check"] = time.perf_counter() - t
    t = time.perf_counter()
    sweep46 = slice_sweep_phase(dev, vision_mods, stamp)
    nn_s["nn_sweep"] = time.perf_counter() - t

    f = flash[("gpt_1p3b", 2048, torch.bfloat16)]
    ft = flash[("gpt_1p3b_train", 2048, torch.bfloat16)]
    p = paged[("ragged", torch.bfloat16)]
    pe = paged[("engine", torch.bfloat16)]
    fb = flash_bwd[("gpt_1p3b_train", torch.bfloat16)]
    fm = fmlp[(8192, torch.bfloat16)]
    tl = train["launches"]
    ob = opt["gpt_1p3b_f32"]
    i8r = i8[(8, 2048, 8192)]
    f8r = fp8[(8192, 2048, 8192, torch.bfloat16, "col")]
    gr = gather[("training", torch.bfloat16)]
    al = addln[(16384, 768, torch.float32)]    # BERT-base's shape and dtype
    bl = bert["fused"]["launches"]
    plain = ("ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        # the Hopper flash and fp8 kernels also carry their and the
        # library call's times per call of 20 issued back to back
        # ("batch_ms", "library_batch_ms"), beside the lone-call times of
        # every kernel
        dict(_kernel("flash_attention_fwd",
                     "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                     "paddle_tpu/ops/flash_attention.py:88",
                     runs[False]["launches"]["flash_attention_fwd"], f,
                     f["max_abs_err_o"], plain, "library_ms"),
             **_batch_keys(f), training_shape=_shape_keys(ft)),
        # "ms" is the kernel's own device time (torch.profiler) after a
        # flush that leaves the L2 dirty, where the trace has it;
        # "kernel_ms_warm" / "_clean" the same without a flush and after
        # one that leaves it clean; "call_ms" the lone call's (CUDA events
        # around the wrapper: its host work held), as add-LN's rows below;
        # "engine_shape": the same at 8 slots of ~1040 tokens
        dict(_kernel("paged_attention_decode",
                     "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/paged_attention.py:77",
                     runs[True]["launches"]["paged_attention_decode"], p,
                     p["max_abs_err"],
                     ("kernel_ms" if p["kernel_ms"] else "ms", "plain_ms",
                      "bound_ms", "bound_by"), None),
             call_ms=p["ms"], kernel_ms_warm=p["kernel_ms_warm"],
             kernel_ms_clean=p["kernel_ms_clean"],
             kernels_per_call=p["kernels_per_call"],
             engine_shape={k: pe[k] for k in (
                 "kernel_ms", "kernel_ms_warm", "kernel_ms_clean", "ms",
                 "bound_ms", "max_abs_err")},
             fleet_launches_by_decode_host={
                 "f32_host_loss":
                     fleet["f32_host_loss"]["paged_launches_by_decode_host"],
                 "f32_partition":
                     fleet["f32_partition"]["paged_launches_by_decode_host"],
                 "bf16": fleet["bf16"]["paged_launches_by_decode_host"],
                 "processes": {h: r["paged_launches"] for h, r in
                               fleet_procs["host_reports"].items()}}),
        dict(_kernel("flash_attention_bwd",
                     "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                     "paddle_tpu/ops/flash_attention.py:200",
                     tl["flash_attention_bwd"], fb,
                     max(fb["max_abs_err"].values()), plain, "library_ms"),
             **_batch_keys(fb)),
        # no single PyTorch call computes the MLP either way: the composed
        # cuBLAS forward is the forward's yardstick ("composed_ms")
        dict(_kernel("fused_ln_mlp_fwd",
                     "paddle_tpu_torch/csrc/fused_ln_mlp.cu",
                     "paddle_tpu/ops/fused_kernels.py:104",
                     tl["fused_ln_mlp_fwd"], fm, fm["max_abs_err_y"],
                     ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms",
                      "fwd_bound_by"), None),
             composed_ms=fm["composed_cublas_fwd_ms"],
             kernels_ms=fm["fwd_kernels_ms"]),
        # no single PyTorch call computes the MLP's backward: the composed
        # cuBLAS backward is the yardstick ("composed_ms"); "kernels_ms" is
        # each of its kernels' own device time (torch.profiler)
        dict(_kernel("fused_ln_mlp_bwd",
                     "paddle_tpu_torch/csrc/fused_ln_mlp.cu",
                     "paddle_tpu/ops/fused_kernels.py:155",
                     tl["fused_ln_mlp_bwd"], fm,
                     max(fm["max_abs_err_grads"].values()),
                     ("bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                      "bwd_bound_by"), None),
             composed_ms=fm["composed_cublas_bwd_ms"],
             kernels_ms=fm["bwd_kernels_ms"]),
        _kernel("fused_ln_mlp_bwd_dw2",
                "paddle_tpu_torch/csrc/fused_ln_mlp.cu",
                "paddle_tpu/ops/fused_kernels.py:220",
                tl["fused_ln_mlp_bwd_dw2"], fm, fm["max_abs_err_dw2"],
                ("dw2_ms", "dw2_plain_ms", "dw2_bound_ms", "dw2_bound_by"),
                None),
        # "captured_launches": phase 41's, replayed inside the captured
        # TrainStep of paddle.Model.fit (one a step)
        dict(_kernel("fused_adamw",
                     "paddle_tpu_torch/csrc/fused_optimizer.cu",
                     "paddle_tpu/ops/fused_optimizer.py:113",
                     train_f["launches"]["fused_adamw"], ob,
                     ob["adamw_max_abs_err"],
                     ("adamw_ms", "adamw_plain_ms", "adamw_bound_ms",
                      "adamw_bound_by"), "adamw_library_ms"),
             captured_launches=lenet_m["launches"]["fused_adamw"],
             seq2seq_captured_launches=s2s["launches"]["fused_adamw"]),
        _kernel("fused_lamb", "paddle_tpu_torch/csrc/fused_optimizer.cu",
                "paddle_tpu/ops/fused_optimizer.py:209",
                lamb["launches"]["fused_lamb"], ob, ob["lamb_max_abs_err"],
                ("lamb_ms", "lamb_plain_ms", "lamb_bound_ms",
                 "lamb_bound_by"), None),
        # "kernel_ms": the kernel's own device time; "fused_quant": the
        # entry that quantizes bf16 activations on the card (the
        # engine's), beside the composed quantization plus the kernel
        dict(_kernel("int8_matmul", "paddle_tpu_torch/csrc/int8_matmul.cu",
                     "paddle_tpu/ops/int8_matmul.py:44",
                     runs8[False]["launches"]["int8_matmul"], i8r,
                     i8r["max_abs_err"], plain, "library_ms"),
             kernel_ms=i8r["kernel_ms"], batch_ms=i8r["batch_ms"],
             fused_quant=i8r["fused_quant"]),
        dict(_kernel("fp8_matmul", "paddle_tpu_torch/csrc/fp8_matmul.cu",
                     "paddle_tpu/ops/fp8_matmul.py:51",
                     train_fp8["launches"]["fp8_matmul"], f8r,
                     f8r["max_abs_err"], plain, "library_ms"),
             **_batch_keys(f8r),
             second_shape=_shape_keys(fp8[(8192, 8192, 2048, torch.bfloat16,
                                           "col")])),
        # "ms" / "library_ms": lone calls; "kernel_ms" /
        # "library_kernel_ms": the gather's and index_select's kernels
        # alone (torch.profiler, after the L2 flush)
        dict(_kernel("moe_dispatch_gather",
                     "paddle_tpu_torch/csrc/moe_dispatch.cu",
                     "paddle_tpu/ops/moe_dispatch.py:55",
                     runs_moe[False]["launches"]["moe_dispatch_gather"], gr,
                     gr["max_abs_err"], plain, "library_ms"),
             kernel_ms=gr["kernel_ms"],
             library_kernel_ms=gr["library_kernel_ms"]),
        # no single PyTorch call computes LN(x + y): the add followed by
        # F.layer_norm is the yardstick ("composed_ms"), as the composed
        # cuBLAS MLP is the fused LN-MLP's. "ms" is the kernels' own
        # device time (torch.profiler) where the trace has it: the call
        # time of a ~50 µs kernel (CUDA events around the wrapper,
        # "call_ms") also holds the Python wrapper's enqueue
        dict(_kernel("fused_add_ln_fwd",
                     "paddle_tpu_torch/csrc/fused_add_ln.cu",
                     "paddle_tpu/ops/fused_kernels.py:500",
                     bl["fused_add_ln_fwd"], al, al["max_abs_err_out"],
                     ("fwd_kernel_ms" if al["fwd_kernel_ms"] else "fwd_ms",
                      "fwd_plain_ms", "fwd_bound_ms", "fwd_bound_by"), None),
             call_ms=al["fwd_ms"], composed_ms=al["fwd_composed_ms"]),
        dict(_kernel("fused_add_ln_bwd",
                     "paddle_tpu_torch/csrc/fused_add_ln.cu",
                     "paddle_tpu/ops/fused_kernels.py:512",
                     bl["fused_add_ln_bwd"], al, al["max_abs_err_dx"],
                     ("bwd_kernel_ms" if al["bwd_kernel_ms"] else "bwd_ms",
                      "bwd_plain_ms", "bwd_bound_ms", "bwd_bound_by"), None),
             call_ms=al["bwd_ms"], composed_ms=al["bwd_composed_ms"]),
    ]
    # launches on each path, every count set to 0 just before its run
    paths = {"serving_fixed": runs[False]["launches"],
             "serving_paged": runs[True]["launches"], "training": tl,
             "training_fused_adamw": train_f["launches"],
             "training_fused_lamb": lamb["launches"],
             "serving_int8_fixed": runs8[False]["launches"],
             "serving_int8_paged": runs8[True]["launches"],
             "training_fp8": train_fp8["launches"],
             "serving_moe_fixed": runs_moe[False]["launches"],
             "serving_moe_paged": runs_moe[True]["launches"],
             "training_moe": train_moe["launches"],
             "training_paddle_bert_composed": bert["composed"]["launches"],
             "training_paddle_bert_fused": bl,
             "serving_spec_fixed": runs_spec[False]["launches"],
             "serving_spec_paged": runs_spec[True]["launches"],
             "serving_prefix_paged": prefix["launches"],
             **{f"serving_watchdog_{k}": v
                for k, v in wd["launches"].items()},
             "serving_overload_spec_paged": ov["launches"],
             "serving_kv_stream_paged": kv["launches"],
             "serving_failover_fixed": fo_run["launches"],
             "serving_router_chaos_f32_paged": chaos["f32"]["launches"],
             "serving_router_chaos_paged": chaos["bf16"]["paged"]["launches"],
             "serving_router_chaos_int8_fixed":
                 chaos["bf16"]["int8_fixed"]["launches"],
             "serving_supervisor_f32_paged": life["launches"],
             "serving_frontend_paged": front["launches"],
             "training_paddle_lenet": lenet["launches"],
             "training_paddle_resnet50_o2": resnet["launches"],
             # phase 41: row 7 inside the captured TrainStep of
             # paddle.Model.fit (one launch a replayed step)
             "training_paddle_model_lenet": lenet_m["launches"],
             "training_paddle_trainstep_resnet50_o2": resnet_ts["launches"],
             "training_paddle_trainstep_mobilenet_v2_o2":
                 mobilenet_ts["launches"],
             # phase 45: row 7 inside the captured seq2seq step
             "training_paddle_trainstep_seq2seq": s2s["launches"],
             "paddle_nn_sweep": sweep46["launches"],
             "serving_fleet_f32_host_loss":
                 fleet["f32_host_loss"]["launches"],
             "serving_fleet_f32_partition":
                 fleet["f32_partition"]["launches"],
             "serving_fleet_bf16_paged": fleet["bf16"]["launches"],
             # counted in the host processes, which report them
             "serving_fleet_processes": {
                 "paged_attention_decode": sum(
                     r["paged_launches"]
                     for r in fleet_procs["host_reports"].values()),
                 "flash_attention_fwd": sum(
                     r["flash_launches"]
                     for r in fleet_procs["host_reports"].values())}}
    for k in kernels:
        k["launches_by_path"] = {name: counts.get(k["name"], 0)
                                 for name, counts in paths.items()}
    emit({"phase": "seconds", "resilience_phases_s": res_s,
          "resilience_total_s": sum(res_s.values()),
          "orchestration_phases_s": orch_s,
          "orchestration_total_s": sum(orch_s.values()),
          "vision_phases_s": vision_s,
          "vision_total_s": sum(vision_s.values()),
          "fleet_phases_s": fleet_s,
          "fleet_total_s": sum(fleet_s.values()),
          "entry_phases_s": entry_s,
          "entry_total_s": sum(entry_s.values()),
          "surface_phases_s": surface_s,
          "surface_total_s": sum(surface_s.values()),
          "nn_phases_s": nn_s, "nn_total_s": sum(nn_s.values()),
          "smoke_s": time.perf_counter() - t_main, **stamp})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
