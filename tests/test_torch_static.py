"""The port's static-graph world against paddle_tpu's, on the CPU
(``Executor(CPUPlace())``: uncaptured runs).

- recording, not executing: ops on placeholders give SymbolicTensors and
  program ops (as many as the JAX program's), a host read raises, an op
  with a data-dependent shape cannot be recorded;
- the introspection surface (blocks, vars, op types, output names,
  attrs, the out-of-range errors) equal to the JAX program's;
- Executor fetches, a -1 batch fed at two sizes (a plan each), the
  ``append_backward`` gradients and ``static.gradients`` against the
  JAX package's within 1e-6 of the largest value;
- ``minimize``: the fetches are the values before the update, two specs
  run in order (each sees the other's update), and 3 steps of the 2-layer
  ``bert_model`` composed and fused: losses within 1e-5 relative, and
  under SGD and Momentum every parameter within 1e-5 of its largest
  value (1e-5 for a leaf of rounding noise, below 1e-5); under AdamW
  the losses only (near-zero gradients: Adam moves
  such an element by ~lr whatever sign its last bits give, see
  ``test_torch_guardian.py``'s ``PARAM_ABS`` note). The reference here is
  the JAX package's EAGER run: its static program computes an op on a
  parameter with no placeholder argument (the position embedding of
  ``paddle.arange``) at build time and never trains that parameter,
  where the port records the op and trains it, as Paddle does
  (``test_jax_static_freezes_build_time_parameter_ops``);
- control flow (cond, case, switch_case, while_loop) against the JAX
  programs;
- ``static.save`` / ``load`` round trip, and a file the JAX package's
  ``static.save`` wrote loaded by the port;
- the export family raising for ROADMAP item 11; dropout in a program
  drawing a fresh mask every run (the JAX program freezes its build-time
  mask: a deliberate difference), checked on its keep rate.

Static mode and the default programs are process-wide: every test
restores dynamic mode and fresh default programs in both packages.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import static as jstatic
from paddle_tpu.core import native as jnative
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import core as tcore
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-6
LOSS_REL = 1e-5
PARAM_TOL = 1e-5
# a leaf whose largest value is below this holds rounding noise only (the
# key projection's bias: softmax is shift-invariant, so its gradient is 0
# in exact arithmetic and ~1e-12 in both packages): its scale is this
PARAM_FLOOR = 1e-5
SMALL = dict(vocab=512, hidden=128, layers=2, heads=4, ffn=512, seq=64)
_rng = np.random.default_rng(20)
IDS = _rng.integers(0, SMALL["vocab"], (2, SMALL["seq"]))
LABELS = _rng.integers(0, SMALL["vocab"], (2, SMALL["seq"]))
STEPS = 3


def _fresh_programs():
    tstatic.reset_default_programs()
    jstatic._default_main[0] = jstatic.Program()
    jstatic._default_startup[0] = jstatic.Program()


@pytest.fixture(autouse=True)
def isolated():
    old_dev = tdevice._current[0]
    old_flags = [(jnative.fused_kernels[0], jnative.fused_optimizer[0]),
                 (tflags.fused_kernels[0], tflags.fused_optimizer[0])]
    paddle_tpu_torch.set_device("cpu")
    _fresh_programs()
    yield
    paddle_tpu.disable_static()
    paddle_tpu_torch.disable_static()
    _fresh_programs()
    tdevice._current[0] = old_dev
    jnative.fused_kernels[0], jnative.fused_optimizer[0] = old_flags[0]
    tflags.fused_kernels[0], tflags.fused_optimizer[0] = old_flags[1]


def _close(got, want, tol=TOL, floor=1e-30):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), floor)
    assert np.abs(np.asarray(got, np.float64) - want).max() <= tol * scale


def _mlp(P):
    """A 2-layer MLP of the package ``P``."""
    nn = P.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(6, 8)
            self.fc2 = nn.Linear(8, 3)

        def forward(self, x):
            h = P.nn.functional.relu(self.fc1(x))
            return h, P.tanh(self.fc2(h))

    return MLP()


def _pair():
    """The MLP in both packages, the JAX weights carried to the port."""
    paddle_tpu.seed(3)
    jm = _mlp(paddle_tpu)
    tm = _mlp(paddle_tpu_torch)
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _program(P, S, build):
    """Record ``build()`` into a fresh program of package ``P``."""
    P.enable_static()
    main, startup = S.Program(), S.Program()
    with S.program_guard(main, startup):
        out = build()
    return main, out


def test_ops_record_not_execute():
    counts = []
    for P, S in ((paddle_tpu, jstatic), (paddle_tpu_torch, tstatic)):
        def build():
            x = S.data("x", [-1, 4])
            return x * 2.0 + 1.0
        main, y = _program(P, S, build)
        assert isinstance(y, S.SymbolicTensor)
        with pytest.raises(RuntimeError):
            y.numpy()
        counts.append(len(main.ops))
        P.disable_static()
    assert counts[0] == counts[1] >= 1
    with pytest.raises(RuntimeError):
        float(y)


def test_data_dependent_shape_cannot_be_recorded():
    paddle_tpu_torch.enable_static()
    with tstatic.program_guard(tstatic.Program()):
        x = tstatic.data("x", [4])
        with pytest.raises(RuntimeError, match="cannot be recorded"):
            paddle_tpu_torch.nonzero(x)


def test_hook_is_off_in_dynamic_mode():
    paddle_tpu_torch.enable_static()
    assert tcore._symbolic_dispatch_hook[0] is not None
    paddle_tpu_torch.disable_static()
    assert tcore._symbolic_dispatch_hook[0] is None
    assert paddle_tpu_torch.in_dynamic_mode()
    t = paddle_tpu_torch.to_tensor([1.0, 2.0]) * 3.0
    np.testing.assert_array_equal(t.numpy(), [3.0, 6.0])


def test_introspection_matches_jax():
    views = []
    for P, S in ((paddle_tpu, jstatic), (paddle_tpu_torch, tstatic)):
        def build():
            lin = P.nn.Linear(4, 2)
            # explicit names: the automatic ones count layers made
            # earlier in the process, which differ between packages
            lin.weight.name, lin.bias.name = "fc_w", "fc_b"
            x = S.data("x", [-1, 4])
            return P.sum(P.tanh(lin(x * 2.0 + 1.0)), axis=1)
        main, _ = _program(P, S, build)
        block = main.global_block()
        ops = block.ops
        views.append({
            "blocks": main.num_blocks,
            "types": [op.type for op in ops],
            "outs": [op.output_arg_names for op in ops],
            "named_ins": [[n for n in op.input_arg_names
                           if not n.startswith("tensor_")] for op in ops],
            "last_attrs": (ops[-1].attr("axis"), ops[-1].attr_names),
            "vars": {n: (v.shape, v.persistable)
                     for n, v in block.vars.items() if v.persistable},
            "feed_persistable": block.var("x").persistable,
            "text": "block 0 {" in str(main) and "var x" in str(main),
            "params": sorted(p.name for p in main.all_parameters()),
        })
        with pytest.raises(IndexError):
            main.block(1)
        with pytest.raises(KeyError):
            block.var("nope")
        shape_x = block.var("x").shape
        P.disable_static()
    assert views[0] == views[1]
    assert views[1]["types"] == ["multiply", "add", "_linear", "tanh",
                                 "_sum"]
    # the feed's runtime dim reads -1, as the reference's Variable has it
    # (the JAX block reports the build shape, 1)
    assert shape_x == [-1, 4]


def test_executor_fetches_match_jax():
    jm, tm = _pair()
    xs = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
    got = {}
    for P, S, m, place in ((paddle_tpu, jstatic, jm, None),
                           (paddle_tpu_torch, tstatic, tm,
                            paddle_tpu_torch.CPUPlace())):
        main, (h, y) = _program(P, S, lambda: m(S.data("x", [-1, 6])))
        exe = S.Executor(place)
        exe.run(S.default_startup_program())
        got[P] = exe.run(main, feed={"x": xs}, fetch_list=[h, y])
        P.disable_static()
    for a, b in zip(got[paddle_tpu_torch], got[paddle_tpu]):
        _close(a, b)


def test_dynamic_batch_takes_a_plan_per_feed_shape():
    jm, tm = _pair()
    rng = np.random.default_rng(2)
    main, (_, y) = _program(paddle_tpu_torch, tstatic,
                            lambda: tm(tstatic.data("x", [-1, 6])))
    exe = tstatic.Executor(paddle_tpu_torch.CPUPlace())
    for n in (3, 7, 3):
        xs = rng.normal(size=(n, 6)).astype(np.float32)
        (out,) = exe.run(main, feed={"x": xs}, fetch_list=[y])
        paddle_tpu_torch.disable_static()
        want = jm(paddle_tpu.to_tensor(xs))[1].numpy()
        _close(out, want)
        paddle_tpu_torch.enable_static()
    assert len(exe._cache) == 2
    # a new dtype is a new signature too
    exe.run(main, feed={"x": rng.normal(size=(3, 6))}, fetch_list=[y])
    assert len(exe._cache) == 2   # fed as the placeholder's f32


def test_append_backward_and_gradients_match_jax():
    jm, tm = _pair()
    xs = np.random.default_rng(4).normal(size=(4, 6)).astype(np.float32)
    got = {}
    for P, S, m, place in ((paddle_tpu, jstatic, jm, None),
                           (paddle_tpu_torch, tstatic, tm,
                            paddle_tpu_torch.CPUPlace())):
        def build():
            loss = P.mean(m(S.data("x", [-1, 6]))[1] ** 2)
            pg = S.append_backward(loss)
            return loss, pg
        main, (loss, pg) = _program(P, S, build)
        exe = S.Executor(place)
        vals = exe.run(main, feed={"x": xs},
                       fetch_list=[loss] + [g for _, g in pg])
        names = {id(p): n for n, p in m.named_parameters()}
        got[P] = (vals[0], {names[id(p)]: v for (p, _), v in
                            zip(pg, vals[1:])})
        P.disable_static()
    (jl, jg), (tl, tg) = got[paddle_tpu], got[paddle_tpu_torch]
    _close(tl, jl)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        _close(tg[k], jg[k])
    # static.gradients: the same symbols for a chosen parameter
    main, (loss, gw) = _program(
        paddle_tpu_torch, tstatic,
        lambda: (lambda lo: (lo, tstatic.gradients(lo, [tm.fc1.weight])))(
            paddle_tpu_torch.mean(tm(tstatic.data("x", [-1, 6]))[1] ** 2)))
    (g,) = tstatic.Executor(paddle_tpu_torch.CPUPlace()).run(
        main, feed={"x": xs}, fetch_list=gw)
    _close(g, jg["fc1.weight"])


def _two_spec_program(P, S, m):
    """Two losses over disjoint parameters (a GAN's d and g), two SGD
    optimizers minimizing them in order."""
    x = S.data("x", [-1, 6])
    h, y = m(x)
    d_loss = P.mean(y ** 2)
    g_loss = P.mean((h - 0.5) ** 2)
    P.optimizer.SGD(0.1, parameters=m.fc2.parameters()).minimize(d_loss)
    P.optimizer.SGD(0.1, parameters=m.fc1.parameters()).minimize(g_loss)
    return d_loss, g_loss


def test_fetches_precede_updates_and_specs_run_in_order():
    jm, tm = _pair()
    xs = np.random.default_rng(5).normal(size=(4, 6)).astype(np.float32)
    runs = {}
    for P, S, m, place in ((paddle_tpu, jstatic, jm, None),
                           (paddle_tpu_torch, tstatic, tm,
                            paddle_tpu_torch.CPUPlace())):
        main, (d_loss, g_loss) = _program(
            P, S, lambda: _two_spec_program(P, S, m))
        assert len(main.train_specs) == 2
        exe = S.Executor(place)
        w_before = m.fc2.weight.numpy().copy()
        out = []
        for _ in range(2):
            out.append(exe.run(main, feed={"x": xs},
                               fetch_list=[d_loss, g_loss, m.fc2.weight]
                               if P is paddle_tpu_torch
                               else [d_loss, g_loss]))
        runs[P] = (out, {k: v.numpy() for k, v in m.state_dict().items()})
        if P is paddle_tpu_torch:
            # the fetched parameter is its value before the run's update
            np.testing.assert_array_equal(out[0][2], w_before)
            assert not np.array_equal(out[1][2], w_before)
        P.disable_static()
    (jo, jp), (to, tp) = runs[paddle_tpu], runs[paddle_tpu_torch]
    for a, b in zip(to, jo):
        _close(a[0], b[0])
        _close(a[1], b[1])
    for k in jp:
        _close(tp[k], jp[k])


def _bert_pair(form):
    paddle_tpu.seed(11)
    jm = chip_smoke.bert_model(paddle_tpu, **SMALL)
    tm = chip_smoke.bert_model(paddle_tpu_torch, **SMALL)
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    if form == "fused":
        return (chip_smoke.bert_fused_model(paddle_tpu, jm),
                chip_smoke.bert_fused_model(paddle_tpu_torch, tm))
    return jm, tm


OPTS = {"SGD": {}, "Momentum": {"momentum": 0.9},
        "AdamW": {"weight_decay": 0.01}}


def _set_flags(v):
    for P in (paddle_tpu, paddle_tpu_torch):
        P.set_flags({"FLAGS_fused_kernels": v, "FLAGS_fused_optimizer": v})


_JAX_EAGER = {}


def _jax_eager(form, opt):
    """The JAX package's eager run (module cache), with the weights the
    port's program starts from."""
    key = (form, opt)
    if key not in _JAX_EAGER:
        jm, tm = _bert_pair(form)
        start = {k: v.numpy() for k, v in tm.state_dict().items()}
        o = getattr(paddle_tpu.optimizer, opt)(
            learning_rate=1e-3, parameters=jm.parameters(), **OPTS[opt])
        ids, labels = paddle_tpu.to_tensor(IDS), paddle_tpu.to_tensor(LABELS)
        losses = []
        for _ in range(STEPS):
            loss = paddle_tpu.nn.functional.cross_entropy(jm(ids), labels)
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        _JAX_EAGER[key] = (start, losses,
                           {k: v.numpy() for k, v in jm.state_dict().items()})
    return _JAX_EAGER[key]


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("form", ["composed", "fused"])
def test_bert_minimize_matches_jax(form, opt):
    _set_flags(int(form == "fused"))
    start, jl, jp = _jax_eager(form, opt)
    paddle_tpu_torch.seed(11)
    tm = chip_smoke.bert_model(paddle_tpu_torch, **SMALL)
    if form == "fused":
        tm = chip_smoke.bert_fused_model(paddle_tpu_torch, tm)
    tm.set_state_dict(start)

    def build():
        ids = tstatic.data("ids", [2, SMALL["seq"]], "int64")
        labels = tstatic.data("labels", [2, SMALL["seq"]], "int64")
        loss = paddle_tpu_torch.nn.functional.cross_entropy(tm(ids), labels)
        getattr(paddle_tpu_torch.optimizer, opt)(
            learning_rate=1e-3, **OPTS[opt]).minimize(loss)
        return loss

    main, loss = _program(paddle_tpu_torch, tstatic, build)
    exe = tstatic.Executor(paddle_tpu_torch.CPUPlace())
    exe.run(tstatic.default_startup_program())
    tl = [float(exe.run(main, feed={"ids": IDS, "labels": LABELS},
                        fetch_list=[loss])[0]) for _ in range(STEPS)]
    assert max(abs(a - b) / abs(a) for a, b in zip(jl, tl)) <= LOSS_REL, \
        (jl, tl)
    if opt != "AdamW":
        tp = {k: v.numpy() for k, v in tm.state_dict().items()}
        assert sorted(tp) == sorted(jp)
        for k in jp:
            _close(tp[k], jp[k], PARAM_TOL, PARAM_FLOOR)


def test_jax_static_freezes_build_time_parameter_ops():
    """The position embedding of ``paddle.arange(seq)`` has no
    placeholder argument: the JAX program computes it at build time and
    never trains ``pos.weight``; the port records it and trains it as
    the eager step does."""
    start, _, jp = _jax_eager("composed", "SGD")
    jm = chip_smoke.bert_model(paddle_tpu, **SMALL)
    jm.set_state_dict(start)
    paddle_tpu.enable_static()
    with jstatic.program_guard(jstatic.Program()):
        loss = paddle_tpu.nn.functional.cross_entropy(
            jm(jstatic.data("ids", [2, SMALL["seq"]], "int64")),
            jstatic.data("labels", [2, SMALL["seq"]], "int64"))
        paddle_tpu.optimizer.SGD(1e-3).minimize(loss)
        prog = jstatic.default_main_program()
    exe = jstatic.Executor()
    for _ in range(STEPS):
        exe.run(prog, feed={"ids": IDS, "labels": LABELS}, fetch_list=[loss])
    np.testing.assert_array_equal(jm.pos.weight.numpy(), start["pos.weight"])
    assert not np.allclose(jp["pos.weight"], start["pos.weight"])


def test_control_flow_matches_jax():
    xs = np.array([[0.5, -1.0, 2.0]], np.float32)
    got = {}
    for P, S, place in ((paddle_tpu, jstatic, None),
                        (paddle_tpu_torch, tstatic,
                         paddle_tpu_torch.CPUPlace())):
        def build():
            x = S.data("x", [1, 3])
            i = S.data("i", [1], "int64")
            s = P.sum(x)
            c = S.nn.cond(s > 1.0, lambda: x * 2.0, lambda: x - 1.0)
            k = S.nn.case([(s > 5.0, lambda: x + 10.0),
                           (s > 1.0, lambda: x + 20.0)],
                          default=lambda: x + 30.0)
            w = S.nn.switch_case(i, [lambda: x * 3.0, lambda: x * 4.0,
                                     lambda: x * 5.0])
            n = P.zeros([1], "float32")
            (lp,) = S.nn.while_loop(lambda v: P.sum(v) < 10.0,
                                    lambda v: [v + P.abs(s) + 0.5], [n])
            return c, k, w, lp
        main, outs = _program(P, S, build)
        exe = S.Executor(place)
        got[P] = [exe.run(main, feed={"x": xs * f, "i": np.array([j])},
                          fetch_list=list(outs))
                  for f, j in ((1.0, 0), (-1.0, 2), (3.0, 1))]
        P.disable_static()
    for a, b in zip(got[paddle_tpu_torch], got[paddle_tpu]):
        for u, v in zip(a, b):
            _close(u, v)


def test_save_load_roundtrip_and_a_jax_file(tmp_path):
    jm, tm = _pair()
    main, _ = _program(paddle_tpu_torch, tstatic,
                       lambda: tm(tstatic.data("x", [-1, 6])))
    paddle_tpu_torch.disable_static()
    tstatic.save(main, str(tmp_path / "port"))
    saved = {k: v.numpy() for k, v in tm.state_dict().items()}
    for p in tm.parameters():
        p.set_value(np.zeros(p.shape, np.float32))
    tstatic.load(main, str(tmp_path / "port"))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[k])
    state = tstatic.load_program_state(str(tmp_path / "port"))
    assert sorted(state) == sorted(p.name for p in main.all_parameters())
    # a file the JAX package's static.save wrote
    paddle_tpu.seed(9)
    jm2 = _mlp(paddle_tpu)
    jmain, _ = _program(paddle_tpu, jstatic,
                        lambda: jm2(jstatic.data("x", [-1, 6])))
    paddle_tpu.disable_static()
    jstatic.save(jmain, str(tmp_path / "jax"))
    by_name = {p.name: p for p in jmain.all_parameters()}
    # the port's parameters take the JAX file's names
    for tp, jp in zip(tm.parameters(), jm.parameters()):
        tp.name = jp.name
    for tp, jp2 in zip(tm.parameters(), jm2.parameters()):
        tp.name = jp2.name
    tstatic.load(main, str(tmp_path / "jax"))
    for tp in tm.parameters():
        np.testing.assert_array_equal(tp.numpy(), by_name[tp.name].numpy())
    tstatic.set_program_state(main, {tm.fc1.bias.name: np.ones(8, "f4")})
    np.testing.assert_array_equal(tm.fc1.bias.numpy(), np.ones(8))


@pytest.mark.parametrize("name", [
    "save_inference_model", "load_inference_model", "serialize_program",
    "serialize_persistables", "deserialize_program",
    "deserialize_persistables"])
def test_export_family_raises_for_item_11(name):
    fn = getattr(tstatic, name)
    n_args = {"save_inference_model": 4, "load_inference_model": 2,
              "serialize_program": 2, "serialize_persistables": 2,
              "deserialize_program": 1, "deserialize_persistables": 2}[name]
    with pytest.raises(NotImplementedError, match="item 11"):
        fn(*([None] * n_args))


def test_dropout_draws_a_fresh_mask_every_run():
    """A deliberate difference (ROADMAP Queue 3): the port's program
    draws dropout's mask from the device's generator at every run; the
    JAX program keeps the mask drawn at build time."""
    n, p = 20000, 0.3
    masks = {}
    for P, S, place in ((paddle_tpu, jstatic, None),
                        (paddle_tpu_torch, tstatic,
                         paddle_tpu_torch.CPUPlace())):
        main, y = _program(P, S, lambda: P.nn.functional.dropout(
            S.data("x", [n]), p=p))
        exe = S.Executor(place)
        ones = np.ones(n, np.float32)
        masks[P] = [exe.run(main, feed={"x": ones}, fetch_list=[y])[0] != 0
                    for _ in range(2)]
        P.disable_static()
    j, t = masks[paddle_tpu], masks[paddle_tpu_torch]
    np.testing.assert_array_equal(j[0], j[1])
    assert not np.array_equal(t[0], t[1])
    for m in t:
        # keep rate 0.7 within 5 standard deviations of a binomial
        assert abs(m.mean() - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)


def test_eager_minimize_harvests_gradients():
    jm, tm = _pair()
    xs = np.random.default_rng(6).normal(size=(4, 6)).astype(np.float32)
    for P, m in ((paddle_tpu, jm), (paddle_tpu_torch, tm)):
        opt = P.optimizer.Momentum(0.1, parameters=m.parameters())
        loss = P.mean(m(P.to_tensor(xs))[1] ** 2)
        loss.backward()
        opt.minimize(loss)
        opt.clear_gradients()
    for (k, a), (_, b) in zip(tm.state_dict().items(),
                              jm.state_dict().items()):
        _close(a.numpy(), b.numpy())
