"""The slice as a whole on the CPU: ``chip_smoke.py``'s attention
seq2seq (``seq2seq_model``, PaddleNLP's ``seq2seq_attn`` written against
either package's Paddle surface) built on paddle_tpu and on the port at a
tiny size (vocabularies 50 and 40, width 32, 2 layers, batch 4, rows at
full length, dropout 0), the JAX model's state carried across by
``set_state_dict``:

- the masked cross-entropy loss within 1e-5 relative and every
  parameter's gradient within 1e-4 of its largest value;
- 3 Adam steps with ``ClipGradByGlobalNorm(5)`` through the port's
  ``jit.TrainStep`` (uncaptured on the CPU; FLAGS_fused_optimizer 0 and
  1) against the JAX package's eager loop with the same clip (its
  ``TrainStep`` skips ``grad_clip``): every parameter within 1e-5;
- a beam-3, 8-step decode through ``nn.dynamic_decode``: the same
  sequences and lengths, scores within 1e-5;
- ``nn.beam_search`` on ``tests/test_beam_search.py``'s Markov tables.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = {"src_vocab": 50, "trg_vocab": 40, "hidden": 32, "layers": 2,
         "dropout": 0.0, "init_scale": 0.1}
BATCH, MAXLEN = 4, 6
LOSS_REL, GRAD_TOL, PARAM_TOL, SCORE_TOL = 1e-5, 1e-4, 1e-5, 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _models():
    paddle_tpu.seed(0)
    jm = chip_smoke.seq2seq_model(paddle_tpu, **SMALL)
    tm = chip_smoke.seq2seq_model(paddle_tpu_torch, **SMALL)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    missing, unexpected = tm.set_state_dict(state)
    assert not missing and not unexpected
    return jm, tm


def _batch(seed=0):
    return chip_smoke.seq2seq_batch(np.random.default_rng(seed), BATCH,
                                    SMALL["src_vocab"], SMALL["trg_vocab"],
                                    maxlen=MAXLEN, full=True)


def _loss_and_grads(paddle, model, arrays):
    ts = [paddle.to_tensor(a) for a in arrays]
    loss = chip_smoke.seq2seq_loss(paddle, model(*ts[:3]), ts[3], ts[4])
    loss.backward()
    return float(loss.numpy()), {k: p.grad.numpy()
                                 for k, p in model.named_parameters()}


def test_loss_and_gradients_match_jax():
    jm, tm = _models()
    arrays = _batch()
    lj, gj = _loss_and_grads(paddle_tpu, jm, arrays)
    lt, gt = _loss_and_grads(paddle_tpu_torch, tm, arrays)
    assert abs(lt - lj) <= LOSS_REL * abs(lj)
    assert set(gj) == set(gt)
    for k in gj:
        err = np.abs(gj[k] - gt[k]).max()
        assert err <= GRAD_TOL * max(np.abs(gj[k]).max(), 1e-6), (k, err)


@pytest.mark.parametrize("fused", [0, 1])
def test_clipped_adam_trainstep_matches_jax_eager(fused):
    jm, tm = _models()
    batches = [_batch(s) for s in range(3)]
    jopt = paddle_tpu.optimizer.Adam(
        learning_rate=1e-3, parameters=jm.parameters(),
        grad_clip=paddle_tpu.nn.ClipGradByGlobalNorm(5.0))
    for arrays in batches:
        ts = [paddle_tpu.to_tensor(a) for a in arrays]
        chip_smoke.seq2seq_loss(paddle_tpu, jm(*ts[:3]), ts[3],
                                ts[4]).backward()
        jopt.step()
        jopt.clear_grad()
    old = paddle_tpu_torch.get_flags(["FLAGS_fused_optimizer"])
    paddle_tpu_torch.set_flags({"FLAGS_fused_optimizer": fused})
    try:
        topt = paddle_tpu_torch.optimizer.Adam(
            learning_rate=1e-3, parameters=tm.parameters(),
            grad_clip=paddle_tpu_torch.nn.ClipGradByGlobalNorm(5.0))

        def loss_fn(run, src, src_len, trg, label, trg_len):
            return chip_smoke.seq2seq_loss(
                paddle_tpu_torch, run(src, src_len, trg), label, trg_len)

        step = paddle_tpu_torch.jit.TrainStep(tm, loss_fn, topt)
        for arrays in batches:
            float(step(*arrays))
    finally:
        paddle_tpu_torch.set_flags(old)
    want = {k: v.numpy() for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        err = np.abs(want[k] - v.numpy()).max()
        assert err <= PARAM_TOL, (k, err)


def test_beam_decode_matches_jax():
    jm, tm = _models()
    src, src_len = _batch(5)[:2]
    outs = []
    for paddle, model in ((paddle_tpu, jm), (paddle_tpu_torch, tm)):
        model.eval()
        with paddle.no_grad():
            seqs, scores, lengths = chip_smoke.seq2seq_decode(
                paddle, model, paddle.to_tensor(src),
                paddle.to_tensor(src_len), 3, 8)
        outs.append((seqs.numpy(), scores.numpy(), lengths.numpy()))
    (sj, cj, lj), (st, ct, lt) = outs
    np.testing.assert_array_equal(sj, st)
    np.testing.assert_array_equal(lj, lt)
    assert np.abs(cj - ct).max() <= SCORE_TOL * max(np.abs(cj).max(), 1.0)


def _markov(trans):
    table = torch.as_tensor(trans)

    def step(tokens, states):
        return table[tokens], states
    return step


def test_beam_search_finds_the_delayed_reward():
    """test_beam_search.py's table: greedy takes the trap, beam 2 finds
    2 → 3 → EOS; its best beam, score and length as the JAX package's
    (the table ties every continuation of token 1, so only the best
    beam is defined)."""
    V = 5
    t = np.full((V, V), -5.0, np.float32)
    t[0, 1], t[0, 2], t[1, :], t[2, 3], t[3, 4] = -0.3, -0.7, -3.0, -0.01, \
        -0.02
    t[1, 4], t[4, 4] = -3.0, 0.0
    init = {"dummy": np.zeros((1, 1), np.float32)}
    greedy = paddle_tpu_torch.nn.beam_search(_markov(t), init, 0, 4, 1, 3, 1)
    assert greedy[0].numpy()[0, 0, 0] == 1
    want = paddle_tpu.nn.beam_search(
        lambda tok, st: (paddle_tpu.to_tensor(t)._data[tok], st), init, 0, 4,
        2, 3, 1)
    got = paddle_tpu_torch.nn.beam_search(_markov(t), init, 0, 4, 2, 3, 1)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a.numpy())[0, 0],
                                   b.numpy()[0, 0], atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy()[0, 0], [2, 3, 4])
    np.testing.assert_allclose(got[1].numpy()[0, 0], -0.73, atol=1e-5)
    assert int(got[2].numpy()[0, 0]) == 3


def test_finished_beams_continue_with_eos_at_no_cost():
    V = 4
    t = np.full((V, V), -2.0, np.float32)
    t[0, 3] = -0.1
    seqs, scores, lengths = paddle_tpu_torch.nn.beam_search(
        _markov(t), {"d": np.zeros((2, 1), np.float32)}, 0, 3, 2, 4, 2)
    np.testing.assert_allclose(scores.numpy()[:, 0], [-0.1, -0.1],
                               atol=1e-6)
    np.testing.assert_array_equal(seqs.numpy()[0, 0], [3, 3, 3, 3])
    np.testing.assert_array_equal(lengths.numpy()[:, 0], [1, 1])
    with pytest.raises(RuntimeError, match="max_step_num"):
        paddle_tpu_torch.nn.dynamic_decode(
            paddle_tpu_torch.nn.BeamSearchDecoder(
                paddle_tpu_torch.nn.GRUCell(4, 4), 0, 1, 2),
            inits=paddle_tpu_torch.zeros([2, 4]))
