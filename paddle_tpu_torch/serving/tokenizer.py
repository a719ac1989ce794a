"""Byte-level tokenizer front end for the serving engine.

Counterpart of ``paddle_tpu/serving/tokenizer.py`` (pure Python and
numpy, copied so the port imports nothing of the JAX package).

The engine speaks int32 token ids; this module is the minimal text
boundary in front of it:

- :class:`ByteTokenizer` — ids 0..255 are the raw bytes of the utf-8
  encoding (every string round-trips by construction, no OOV), followed
  by special tokens (``<|eos|>`` by default) and, optionally,
  multi-byte MERGE tokens loaded from a vocab file. Encoding is greedy
  longest-match over the byte string, so a merge vocab compresses
  common sequences while the byte floor guarantees totality — the
  GPT-2/BPE shape without requiring a trained merge table.
- :class:`StreamDetokenizer` — incremental decoding for
  ``GenerationRequest.stream_text()``: emitted bytes are buffered until
  they form complete utf-8 sequences, so a multi-byte character split
  across two generated tokens never renders as replacement garbage.

Vocab files: JSON ``{"tokens": ["ab", ...], "specials": ["<|eos|>"]}``
or a plain text file with one token per line (lines become merge
tokens; escape bytes as ``\\xNN``). ``save()`` writes the JSON form.
Merge/special ids start at 256 in file order, so a vocab file is a
stable contract between the engine that served and the client that
decodes.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = ["ByteTokenizer", "StreamDetokenizer"]

_N_BYTES = 256


def _to_bytes(tok: Union[str, bytes]) -> bytes:
    return tok.encode("utf-8") if isinstance(tok, str) else bytes(tok)


class ByteTokenizer:
    """Byte-floor tokenizer with optional merge vocab and specials.

    ::

        tok = ByteTokenizer()                       # pure bytes + <|eos|>
        tok = ByteTokenizer(merges=["the ", "ing"]) # with merge tokens
        tok = ByteTokenizer.load("vocab.json")      # from a vocab file

        ids = tok.encode("hello")          # np.int32 (5,)
        tok.decode(ids)                    # "hello"

    Ids 0..255 are the raw bytes; merge tokens and specials follow.
    ``encode`` is greedy longest-match (merge tokens first, byte
    fallback always succeeds); specials are never produced by
    ``encode`` — they are control ids (``eos_id``) the engine emits and
    ``decode(skip_special=True)`` drops.
    """

    def __init__(self, merges: Optional[Sequence[Union[str, bytes]]] = None,
                 specials: Optional[Sequence[str]] = None):
        self.merges: List[bytes] = [_to_bytes(m) for m in (merges or [])]
        for m in self.merges:
            if len(m) < 2:
                raise ValueError(f"merge token {m!r} shorter than 2 bytes "
                                 "(single bytes are the built-in floor)")
        if len(set(self.merges)) != len(self.merges):
            raise ValueError("duplicate merge tokens in vocab")
        self.specials: List[str] = list(specials) if specials is not None \
            else ["<|eos|>"]
        # merge ids follow the byte floor, specials follow the merges —
        # file order is id order, the stable client contract
        self._merge_ids = {m: _N_BYTES + i for i, m in enumerate(self.merges)}
        self._special_ids = {s: _N_BYTES + len(self.merges) + i
                             for i, s in enumerate(self.specials)}
        self._max_merge = max((len(m) for m in self.merges), default=1)

    # -- core ----------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return _N_BYTES + len(self.merges) + len(self.specials)

    @property
    def eos_id(self) -> Optional[int]:
        return self._special_ids.get("<|eos|>")

    def special_id(self, token: str) -> int:
        return self._special_ids[token]

    def encode(self, text: str) -> np.ndarray:
        """Greedy longest-match over the utf-8 bytes → int32 ids."""
        data = text.encode("utf-8")
        out: List[int] = []
        i, n = 0, len(data)
        while i < n:
            match = None
            for ln in range(min(self._max_merge, n - i), 1, -1):
                tid = self._merge_ids.get(data[i:i + ln])
                if tid is not None:
                    match = (tid, ln)
                    break
            if match is None:
                out.append(data[i])
                i += 1
            else:
                out.append(match[0])
                i += match[1]
        return np.asarray(out, np.int32)

    def token_bytes(self, tid: int) -> Optional[bytes]:
        """The byte expansion of one id; None for specials/out-of-vocab
        (callers skip those)."""
        if 0 <= tid < _N_BYTES:
            return bytes([tid])
        if _N_BYTES <= tid < _N_BYTES + len(self.merges):
            return self.merges[tid - _N_BYTES]
        return None

    def decode(self, ids, skip_special: bool = True) -> str:
        buf = bytearray()
        for tid in ids:
            b = self.token_bytes(int(tid))
            if b is None:
                if not skip_special:
                    name = self.specials[int(tid) - _N_BYTES
                                         - len(self.merges)] \
                        if 0 <= int(tid) - _N_BYTES - len(self.merges) \
                        < len(self.specials) else f"<|{int(tid)}|>"
                    buf.extend(name.encode("utf-8"))
                continue
            buf.extend(b)
        return buf.decode("utf-8", errors="replace")

    def stream_detokenizer(self) -> "StreamDetokenizer":
        return StreamDetokenizer(self)

    # -- vocab files ---------------------------------------------------------
    def save(self, path: str) -> None:
        payload = {
            "tokens": [m.decode("latin-1") for m in self.merges],
            "specials": self.specials,
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "ByteTokenizer":
        """Vocab-file loader: JSON ``{"tokens", "specials"}`` (tokens are
        latin-1-escaped byte strings, the ``save`` format) or plain text
        with one merge token per line (``\\xNN`` escapes allowed)."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"vocab file {path} does not exist")
        with open(path) as f:
            text = f.read()
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            merges = [line.encode("utf-8").decode("unicode_escape")
                      .encode("latin-1")
                      for line in text.splitlines() if line]
            return cls(merges=merges)
        if not isinstance(payload, dict) or "tokens" not in payload:
            raise ValueError(f"{path}: expected a JSON object with a "
                             "'tokens' list (or a plain token-per-line "
                             "file)")
        return cls(merges=[t.encode("latin-1") for t in payload["tokens"]],
                   specials=payload.get("specials"))


class StreamDetokenizer:
    """Incremental byte→text decoder for live token streams.

    ``push(id)`` returns the text that became decodable with this token
    (often ``""`` mid-multibyte-character); ``flush()`` returns whatever
    is still buffered, replacing a trailing incomplete sequence. Special
    ids are skipped."""

    def __init__(self, tokenizer: ByteTokenizer):
        self._tok = tokenizer
        self._buf = bytearray()

    def push(self, tid: int) -> str:
        b = self._tok.token_bytes(int(tid))
        if b is None:
            return ""
        self._buf.extend(b)
        # longest prefix of complete utf-8 sequences: scan back over at
        # most 3 trailing continuation bytes for an unfinished lead byte
        cut = len(self._buf)
        for back in range(1, min(4, cut) + 1):
            byte = self._buf[cut - back]
            if byte < 0x80:               # ascii — complete
                break
            if byte >= 0xC0:              # lead byte: complete iff its
                need = 2 if byte < 0xE0 else 3 if byte < 0xF0 else 4
                if back < need:           # sequence is still short
                    cut -= back
                break
        if cut == 0:
            return ""
        out = bytes(self._buf[:cut]).decode("utf-8", errors="replace")
        del self._buf[:cut]
        return out

    def flush(self) -> str:
        out = bytes(self._buf).decode("utf-8", errors="replace")
        self._buf.clear()
        return out
