"""``paddle_tpu_torch.text`` and ``paddle_tpu_torch.distribution`` against
paddle_tpu's, on the CPU.

- ``viterbi_decode`` / ``ViterbiDecoder`` (with and without the BOS/EOS
  rows, ragged lengths, a length of 1): scores within 1e-5, paths
  exactly; in a static program (lengths fed) the paths keep the full
  length, equal to the eager ones on each sequence's span;
- ``linear_chain_crf``: the cost and its gradients with respect to the
  emissions and the transitions within 1e-5;
- every dataset class against the JAX package's on the same synthetic
  data (no local file): lengths and items equal; ``UCIHousing`` from a
  file the test writes;
- ``Normal``, ``Uniform``, ``Categorical``: ``log_prob``, ``probs``,
  ``entropy``, ``kl_divergence`` and their gradients within 1e-5;
  ``sample``'s shapes, and its moments on 10^5 draws (the generators
  differ, so the draws do).
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

PACKAGES = (paddle_tpu, paddle_tpu_torch)
TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    paddle_tpu_torch.disable_static()
    tstatic.reset_default_programs()
    tdevice._current[0] = old


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0.0) <= tol * max(
        np.abs(want).max(initial=0.0), 1e-30)


RNG = np.random.default_rng(60)
POT = (RNG.normal(size=(4, 7, 5)) * 2).astype("float32")
TRANS = RNG.normal(size=(5, 5)).astype("float32")
LENS = np.array([7, 3, 1, 5], "int64")


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_decode_matches_jax(bos_eos):
    out = {}
    for P in PACKAGES:
        s, p = P.text.viterbi_decode(P.to_tensor(POT), P.to_tensor(TRANS),
                                     P.to_tensor(LENS), bos_eos)
        dec = P.text.ViterbiDecoder(P.to_tensor(TRANS), bos_eos)
        s2, p2 = dec(P.to_tensor(POT[:, :5]), P.to_tensor(
            np.minimum(LENS, 5)))
        out[P] = [x.numpy() for x in (s, p, s2, p2)]
    (js, jp, js2, jp2), (ts, tp, ts2, tp2) = out[paddle_tpu], \
        out[paddle_tpu_torch]
    _close(ts, js)
    _close(ts2, js2)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp2, jp2)


def test_viterbi_in_a_program_keeps_the_full_length():
    lens = np.array([5, 3, 1, 4], "int64")
    want_s, want_p = (x.numpy() for x in paddle_tpu.text.viterbi_decode(
        paddle_tpu.to_tensor(POT), paddle_tpu.to_tensor(TRANS),
        paddle_tpu.to_tensor(lens)))
    paddle_tpu_torch.enable_static()
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        s, p = paddle_tpu_torch.text.viterbi_decode(
            tstatic.data("e", [4, 7, 5]),
            paddle_tpu_torch.to_tensor(TRANS),
            tstatic.data("n", [4], "int64"))
    paddle_tpu_torch.disable_static()
    got_s, got_p = tstatic.Executor(paddle_tpu_torch.CPUPlace()).run(
        main, feed={"e": POT, "n": lens}, fetch_list=[s, p])
    _close(got_s, want_s)
    assert got_p.shape == (4, 7)
    np.testing.assert_array_equal(got_p[:, :want_p.shape[1]], want_p)
    assert not got_p[:, want_p.shape[1]:].any()


def test_linear_chain_crf_and_gradients_match_jax():
    emis = RNG.normal(size=(3, 6, 4)).astype("float32")
    trans = RNG.normal(size=(6, 4)).astype("float32")
    lab = RNG.integers(0, 4, (3, 6))
    lens = np.array([6, 2, 4])
    out = {}
    for P in PACKAGES:
        e = P.to_tensor(emis, stop_gradient=False)
        t = P.to_tensor(trans, stop_gradient=False)
        cost = P.text.linear_chain_crf(e, P.to_tensor(lab), t,
                                       length=P.to_tensor(lens))
        ge, gt = P.grad(P.sum(cost), [e, t])
        out[P] = [cost.numpy(), ge.numpy(), gt.numpy()]
    for g, w in zip(out[paddle_tpu_torch], out[paddle_tpu]):
        _close(g, w)


@pytest.mark.parametrize("name,kwargs", [
    ("UCIHousing", {"mode": "train"}), ("UCIHousing", {"mode": "test"}),
    ("Imdb", {"mode": "train"}), ("Imikolov", {"data_type": "NGRAM",
                                               "window_size": 5}),
    ("Imikolov", {"data_type": "SEQ"}), ("Movielens", {"mode": "test"}),
    ("WMT14", {"mode": "test"}), ("WMT16", {"mode": "val"}),
    ("Conll05st", {})])
def test_dataset_items_match_jax(name, kwargs):
    j = getattr(paddle_tpu.text, name)(**kwargs)
    t = getattr(paddle_tpu_torch.text, name)(**kwargs)
    assert len(j) == len(t)
    for i in (0, 1, len(j) // 2, len(j) - 1):
        a, b = j[i], t[i]
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if hasattr(j, "get_dict"):
        jd = j.get_dict() if name != "WMT16" else j.get_dict("en")
        td = t.get_dict() if name != "WMT16" else t.get_dict("en")
        assert jd == td


def test_uci_housing_reads_a_local_file(tmp_path):
    rows = np.random.default_rng(3).random((20, 14)) * 10
    path = tmp_path / "housing.data"
    np.savetxt(path, rows)
    j = paddle_tpu.text.UCIHousing(data_file=str(path))
    t = paddle_tpu_torch.text.UCIHousing(data_file=str(path))
    assert len(j) == len(t) == 16
    for i in range(len(j)):
        for x, y in zip(j[i], t[i]):
            np.testing.assert_array_equal(x, y)


def _dists(P, loc, scale, logits):
    d = P.distribution
    return (d.Normal(loc, scale), d.Normal(loc * 0.5, scale * 2.0),
            d.Uniform(loc - 1.0, loc + scale), d.Categorical(logits),
            d.Categorical(logits * 0.3))


def test_distributions_match_jax():
    loc0 = RNG.normal(size=(64,)).astype("float32")
    scale0 = (np.abs(RNG.normal(size=(64,))) + 0.2).astype("float32")
    lg0 = RNG.normal(size=(8, 10)).astype("float32")
    v0 = RNG.normal(size=(64,)).astype("float32")
    k0 = RNG.integers(0, 10, (8,))
    out = {}
    for P in PACKAGES:
        loc = P.to_tensor(loc0, stop_gradient=False)
        scale = P.to_tensor(scale0, stop_gradient=False)
        lg = P.to_tensor(lg0, stop_gradient=False)
        n, n2, u, c, c2 = _dists(P, loc, scale, lg)
        v, k = P.to_tensor(v0), P.to_tensor(k0)
        vals = [n.log_prob(v), n.probs(v), n.entropy(), n.kl_divergence(n2),
                u.log_prob(v), u.probs(v), u.entropy(), c.log_prob(k),
                c.probs(k), c.entropy(), c.kl_divergence(c2)]
        total = sum(P.sum(P.where(P.isfinite(x), x, P.zeros_like(x)))
                    for x in vals)
        grads = P.grad(total, [loc, scale, lg])
        out[P] = [x.numpy() for x in vals] + [g.numpy() for g in grads]
    for g, w in zip(out[paddle_tpu_torch], out[paddle_tpu]):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        _close(np.where(fin, g, 0.0), np.where(fin, w, 0.0))


def test_samples_have_the_moments():
    d = paddle_tpu_torch.distribution
    paddle_tpu_torch.seed(5)
    n = 100000
    x = d.Normal(paddle_tpu_torch.to_tensor([1.0, -2.0]),
                 paddle_tpu_torch.to_tensor([0.5, 2.0])).sample([n]).numpy()
    assert x.shape == (n, 2)
    np.testing.assert_allclose(x.mean(0), [1.0, -2.0], atol=5 * 2.0 / 316)
    np.testing.assert_allclose(x.std(0), [0.5, 2.0], rtol=0.02)
    u = d.Uniform(0.0, 4.0).sample([n]).numpy()
    assert 0.0 <= u.min() and u.max() < 4.0
    assert abs(u.mean() - 2.0) < 5 * 4 / np.sqrt(12 * n)
    p = np.array([0.1, 0.2, 0.7], "float32")
    c = d.Categorical(paddle_tpu_torch.to_tensor(np.log(p))).sample(
        [n]).numpy()
    assert c.shape == (n,)
    np.testing.assert_allclose(np.bincount(c, minlength=3) / n, p,
                               atol=5 * np.sqrt(0.7 * 0.3 / n))
    cb = d.Categorical(paddle_tpu_torch.to_tensor(
        np.zeros((4, 3), "f4"))).sample([5]).numpy()
    assert cb.shape == (5, 4)
