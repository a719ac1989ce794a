"""paddle.text (``paddle_tpu/text/__init__.py``; reference
python/paddle/text/__init__.py): the dataset loaders (Conll05st, Imdb,
Imikolov, Movielens, UCIHousing, WMT14, WMT16), ``viterbi_decode`` /
``ViterbiDecoder`` and ``linear_chain_crf`` (fluid.layers re-exports it).

The datasets read the reference's on-disk format from a local
``data_file`` and download nothing; without one they generate the JAX
package's deterministic synthetic data (numpy, the same items).

``viterbi_decode`` runs the reference's per-timestep loop
(viterbi_decode_op.h:300-412) on the device: a forward pass of max /
argmax over the transitions and a reversed backtrack, no host read
inside. Eagerly the paths are cropped to the longest sequence (one host
read of the lengths), as the reference does; recorded into a static
program, where the lengths have no value yet, they keep the full
length, zero-padded past each sequence's end.
"""
from __future__ import annotations

import os
import re
import string
import tarfile

import numpy as np
import torch

from ..framework.core import Tensor, _as_torch, apply_op
from ..io import Dataset
from ..nn import Layer

__all__ = [
    "Conll05st",
    "Imdb",
    "Imikolov",
    "Movielens",
    "UCIHousing",
    "WMT14",
    "WMT16",
    "ViterbiDecoder",
    "viterbi_decode", "linear_chain_crf",
]


# ---------------------------------------------------------------------------
# viterbi decode
# ---------------------------------------------------------------------------

def _viterbi_arrays(potentials, trans, lengths, include_bos_eos_tag):
    """potentials [b, L, n], trans [n, n], lengths [b] int. With
    include_bos_eos_tag the last row of ``trans`` is the start-tag row
    and the second-to-last the stop-tag row; paths are zero past each
    sequence's length."""
    b, L, n = potentials.shape
    lengths = lengths.reshape(-1).long()
    start_row = trans[n - 1]
    stop_row = trans[n - 2]
    alpha = potentials[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + start_row[None]
        alpha = alpha + (lengths == 1).to(alpha.dtype)[:, None] \
            * stop_row[None]
    bps = []
    for t in range(1, L):
        s = alpha[:, :, None] + trans[None]          # [b, prev, next]
        nxt, bp = torch.max(s, dim=1)
        nxt = nxt + potentials[:, t]
        live = (t < lengths)[:, None]
        alpha = torch.where(live, nxt, alpha)
        if include_bos_eos_tag:
            alpha = alpha + (t == lengths - 1).to(alpha.dtype)[:, None] \
                * stop_row[None]
        bps.append(bp)
    scores, final_ids = torch.max(alpha, dim=-1)
    rows = torch.arange(b, device=potentials.device)
    zero = torch.zeros_like(final_ids)
    last_col = torch.where(L - 1 < lengths, final_ids, zero)
    cols = [last_col]
    carry = final_ids
    for t in range(L - 2, -1, -1):
        prev = bps[t][rows, carry]                   # maps tag_{t+1} -> tag_t
        col = torch.where(t >= lengths, zero,
                          torch.where(t == lengths - 1, carry, prev))
        carry = torch.where(t >= lengths, carry, col)
        cols.append(col)
    path = torch.stack(cols[::-1], dim=1)
    return scores, path


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Highest-scoring tag sequence under emissions + transitions:
    (scores [batch], paths [batch, max(lengths)]) as the reference op
    (python/paddle/text/viterbi_decode.py) gives them."""
    if not isinstance(lengths, Tensor):
        lengths = Tensor(_as_torch(np.asarray(lengths), dtype=torch.int64,
                                   device=potentials._data.device))
    pots = potentials
    if not (getattr(lengths, "_symbolic", False)
            or getattr(potentials, "_symbolic", False)):
        lens = lengths._data
        max_len = int(lens.max()) if lens.numel() else 0
        if max_len:
            pots = potentials[:, :max_len]
    scores, path = apply_op(_viterbi_arrays, pots, transition_params,
                            lengths,
                            include_bos_eos_tag=bool(include_bos_eos_tag),
                            op_name="viterbi_decode")
    return scores, path


class ViterbiDecoder(Layer):
    """Layer over :func:`viterbi_decode` (reference
    python/paddle/text/viterbi_decode.py ViterbiDecoder)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

class UCIHousing(Dataset):
    """Boston housing regression set (reference
    python/paddle/text/datasets/uci_housing.py): 13 normalized features,
    1 target; 80/20 train/test split."""

    feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
                     "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT"]

    def __init__(self, data_file=None, mode="train", download=True):
        assert mode.lower() in ("train", "test")
        self.mode = mode.lower()
        raw = self._read(data_file)
        # feature-wise normalization over the train portion, like the
        # reference's load_data (max/min/avg computed on the full matrix)
        feats = raw[:, :-1]
        mx, mn, avg = feats.max(0), feats.min(0), feats.mean(0)
        denom = np.where(mx - mn == 0, 1.0, mx - mn)
        feats = (feats - avg) / denom
        raw = np.concatenate([feats, raw[:, -1:]], axis=1)
        split = int(len(raw) * 0.8)
        self.data = raw[:split] if self.mode == "train" else raw[split:]

    def _read(self, data_file):
        if data_file and os.path.exists(data_file):
            return np.loadtxt(data_file).astype(np.float32)
        rng = np.random.RandomState(42)
        n = 506
        feats = rng.rand(n, 13).astype(np.float32) * 100
        target = (feats @ rng.rand(13).astype(np.float32) / 50)[:, None]
        return np.concatenate([feats, target], axis=1)

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:-1], row[-1:]

    def __len__(self):
        return len(self.data)


class Imdb(Dataset):
    """IMDB sentiment set (reference python/paddle/text/datasets/imdb.py):
    documents as word-id arrays + 0/1 labels + ``word_idx`` vocab."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        assert mode.lower() in ("train", "test")
        self.mode = mode.lower()
        if data_file and os.path.exists(data_file):
            self.word_idx = self._build_word_dict(data_file, cutoff)
            self.docs, self.labels = self._load_anno(data_file)
        else:
            self.word_idx, self.docs, self.labels = self._synthetic()

    def _tokenize(self, data_file, pattern):
        docs = []
        with tarfile.open(data_file) as tarf:
            for tf in tarf:
                if pattern.match(tf.name):
                    text = tarf.extractfile(tf).read().rstrip(b"\n\r")
                    text = text.translate(
                        None, string.punctuation.encode()).lower()
                    docs.append(text.split())
        return docs

    def _build_word_dict(self, data_file, cutoff):
        import collections

        pattern = re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
        freq = collections.defaultdict(int)
        for doc in self._tokenize(data_file, pattern):
            for w in doc:
                freq[w] += 1
        items = sorted((kv for kv in freq.items() if kv[1] > cutoff),
                       key=lambda kv: (-kv[1], kv[0]))
        word_idx = {w: i for i, (w, _) in enumerate(items)}
        word_idx[b"<unk>"] = len(word_idx)
        return word_idx

    def _load_anno(self, data_file):
        unk = self.word_idx[b"<unk>"]
        docs, labels = [], []
        for label, sub in ((0, "pos"), (1, "neg")):
            pattern = re.compile(
                r"aclImdb/%s/%s/.*\.txt$" % (self.mode, sub))
            for doc in self._tokenize(data_file, pattern):
                docs.append(np.array(
                    [self.word_idx.get(w, unk) for w in doc], np.int64))
                labels.append(label)
        return docs, labels

    def _synthetic(self):
        vocab = 5000
        word_idx = {b"w%d" % i: i for i in range(vocab - 1)}
        word_idx[b"<unk>"] = vocab - 1
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        n = 1000
        docs = [rng.randint(0, vocab, size=rng.randint(20, 200)).astype(np.int64)
                for _ in range(n)]
        labels = rng.randint(0, 2, size=n).tolist()
        return word_idx, docs, labels

    def __getitem__(self, idx):
        return np.asarray(self.docs[idx]), np.asarray([self.labels[idx]])

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram set (reference
    python/paddle/text/datasets/imikolov.py): n-grams ('ngram') or
    (cur, next) pairs ('seq')."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        assert data_type.upper() in ("NGRAM", "SEQ")
        self.data_type = data_type.upper()
        self.window_size = window_size
        self.mode = mode.lower()
        sents, self.word_idx = self._sentences(data_file, min_word_freq)
        self.data = []
        for s in sents:
            if self.data_type == "NGRAM":
                if window_size <= 0 or len(s) < window_size:
                    continue
                for i in range(window_size, len(s) + 1):
                    self.data.append(
                        np.array(s[i - window_size:i], np.int64))
            else:
                self.data.append((np.array(s[:-1], np.int64),
                                  np.array(s[1:], np.int64)))

    def _sentences(self, data_file, min_word_freq):
        if data_file and os.path.exists(data_file):
            import collections

            name = ("./simple-examples/data/ptb.%s.txt"
                    % ("train" if self.mode == "train" else "valid"))
            with tarfile.open(data_file) as tarf:
                lines = tarf.extractfile(name).read().decode().split("\n")
            freq = collections.defaultdict(int)
            for ln in lines:
                for w in ln.split():
                    freq[w] += 1
            freq.pop("<unk>", None)
            items = sorted(((w, c) for w, c in freq.items()
                            if c >= min_word_freq),
                           key=lambda kv: (-kv[1], kv[0]))
            word_idx = {w: i for i, (w, _) in enumerate(items)}
            word_idx["<unk>"] = len(word_idx)
            unk, eos = word_idx["<unk>"], len(word_idx)
            word_idx["<e>"] = eos
            sents = [[word_idx.get(w, unk) for w in ln.split()] + [eos]
                     for ln in lines if ln.strip()]
            return sents, word_idx
        vocab = 2000
        word_idx = {"w%d" % i: i for i in range(vocab)}
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        sents = [rng.randint(0, vocab, size=rng.randint(5, 40)).tolist()
                 for _ in range(2000)]
        return sents, word_idx

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """MovieLens-1M ratings (reference
    python/paddle/text/datasets/movielens.py): per-item
    (user_feats..., movie_feats..., rating)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        self.mode = mode.lower()
        rng = np.random.RandomState(rand_seed)
        n_users, n_movies, n_cats = 6040, 3883, 18
        n = 20000
        data_rng = np.random.RandomState(7)
        rows = np.stack([
            data_rng.randint(1, n_users + 1, n),      # user id
            data_rng.randint(0, 2, n),                # gender
            data_rng.randint(0, 7, n),                # age bucket
            data_rng.randint(0, 21, n),               # occupation
            data_rng.randint(1, n_movies + 1, n),     # movie id
            data_rng.randint(0, n_cats, n),           # category
            data_rng.randint(1, 6, n),                # rating 1..5
        ], axis=1).astype(np.int64)
        is_test = rng.rand(n) < test_ratio
        keep = is_test if self.mode == "test" else ~is_test
        self.data = rows[keep]

    def __getitem__(self, idx):
        row = self.data[idx]
        return tuple(np.asarray([v]) for v in row[:-1]) + (
            np.asarray([row[-1]], np.float32),)

    def __len__(self):
        return len(self.data)


class _ParallelCorpus(Dataset):
    """Shared shape for WMT14/WMT16: (src_ids, trg_ids, trg_ids_next)."""

    def __init__(self, mode, src_vocab, trg_vocab, n, seed):
        self.mode = mode
        self.src_dict = {b"w%d" % i: i for i in range(src_vocab)}
        self.trg_dict = {b"w%d" % i: i for i in range(trg_vocab)}
        rng = np.random.RandomState(seed)
        self.src, self.trg = [], []
        for _ in range(n):
            ls = rng.randint(4, 50)
            lt = rng.randint(4, 50)
            self.src.append(rng.randint(2, src_vocab, ls).astype(np.int64))
            # 0 = <s>, 1 = <e> by reference convention
            self.trg.append(rng.randint(2, trg_vocab, lt).astype(np.int64))

    def __getitem__(self, idx):
        src = self.src[idx]
        trg = self.trg[idx]
        trg_in = np.concatenate([[0], trg])
        trg_next = np.concatenate([trg, [1]])
        return src, trg_in, trg_next

    def __len__(self):
        return len(self.src)


class WMT14(_ParallelCorpus):
    """WMT14 en→fr (reference python/paddle/text/datasets/wmt14.py);
    synthetic parallel corpus with reference (src, trg, trg_next) items."""

    def __init__(self, data_file=None, mode="train", dict_size=30000,
                 download=True):
        assert mode.lower() in ("train", "test", "gen")
        super().__init__(mode.lower(), dict_size, dict_size,
                         2000 if mode.lower() == "train" else 200,
                         {"train": 0, "test": 1, "gen": 2}[mode.lower()])

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict


class WMT16(_ParallelCorpus):
    """WMT16 en↔de (reference python/paddle/text/datasets/wmt16.py)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        assert mode.lower() in ("train", "test", "val")
        self.lang = lang
        src_v = src_dict_size if src_dict_size > 0 else 10000
        trg_v = trg_dict_size if trg_dict_size > 0 else 10000
        super().__init__(mode.lower(), src_v, trg_v,
                         2000 if mode.lower() == "train" else 200,
                         {"train": 3, "test": 4, "val": 5}[mode.lower()])

    def get_dict(self, lang, reverse=False):
        d = self.src_dict if lang == self.lang else self.trg_dict
        return {v: k for k, v in d.items()} if reverse else d


class Conll05st(Dataset):
    """CoNLL-2005 SRL set (reference
    python/paddle/text/datasets/conll05.py): per item 8 feature sequences +
    label sequence, plus word/predicate/label dicts."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 mode="test", download=True):
        word_v, verb_v, label_v = 5000, 300, 59
        self.word_dict = {b"w%d" % i: i for i in range(word_v)}
        self.predicate_dict = {b"v%d" % i: i for i in range(verb_v)}
        self.label_dict = {b"l%d" % i: i for i in range(label_v)}
        rng = np.random.RandomState(11)
        n = 500
        self.samples = []
        for _ in range(n):
            ln = rng.randint(5, 60)
            feats = [rng.randint(0, word_v, ln).astype(np.int64)
                     for _ in range(6)]
            mark = rng.randint(0, 2, ln).astype(np.int64)
            pred = np.full(ln, rng.randint(0, verb_v), np.int64)
            label = rng.randint(0, label_v, ln).astype(np.int64)
            self.samples.append(tuple(feats) + (pred, mark, label))

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def get_embedding(self):
        return None

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


def _crf_nll_impl(emis, label, trans, lengths):
    """reference linear_chain_crf_op.h: cost = logZ - score(gold path);
    rows 0 / 1 of the transition matrix are start / stop, the pairwise
    scores trans[2:]."""
    B, T, C = emis.shape
    start, stop, pair = trans[0], trans[1], trans[2:]
    lab = label.reshape(B, T).long()
    lengths = lengths.reshape(-1).long()
    mask = torch.arange(T, device=emis.device)[None, :] \
        < lengths.reshape(-1, 1)                                  # [B, T]
    alpha = start[None, :] + emis[:, 0]                           # [B, C]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + pair[None], dim=1) \
            + emis[:, t]
        alpha = torch.where(mask[:, t:t + 1], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)          # [B]
    zero = torch.zeros((), dtype=emis.dtype, device=emis.device)
    e_score = torch.sum(torch.where(
        mask, torch.gather(emis, 2, lab.unsqueeze(-1)).squeeze(-1), zero),
        dim=1)
    p_score = torch.sum(torch.where(mask[:, 1:],
                                    pair[lab[:, :-1], lab[:, 1:]], zero),
                        dim=1)
    last = torch.clamp(lengths - 1, min=0)
    bi = torch.arange(B, device=emis.device)
    gold = start[lab[:, 0]] + e_score + p_score + stop[lab[bi, last]]
    return (logz - gold)[:, None]


def linear_chain_crf(input, label, param_attr=None, length=None):  # noqa: A002
    """CRF negative log-likelihood (reference linear_chain_crf_op.h):
    ``param_attr`` IS the transition tensor [num_tags + 2, num_tags]
    (rows 0 / 1 start / stop), the learned companion of crf_decoding; the
    program captures it directly where the reference resolves a
    parameter name through the Scope. Returns the per-sequence cost
    [B, 1] (minimize its mean)."""
    B, T = int(input.shape[0]), int(input.shape[1])
    if length is None:
        length = Tensor(torch.full((B,), T, dtype=torch.int64,
                                   device=_device(input)))
    return apply_op(_crf_nll_impl, input, label, param_attr, length,
                    op_name="linear_chain_crf")


def _device(t):
    d = t._data.device
    if d.type == "meta":
        from ..device import current_device

        return current_device()
    return d
