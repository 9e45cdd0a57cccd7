"""CLIP tokenizer with clip.cpp-parity semantics.

The reference tokenizer (upstream clip.cpp:598-679) is *not* a true BPE
merge tokenizer: after a GPT-2-style regex word split it first tries the whole
word + "</w>" as a vocab entry and otherwise falls back to greedy
longest-substring matching against the vocab (leading space included, no
"</w>" suffix in the fallback).  BOS/EOS ids are hardcoded to 49406/49407.
This module reproduces that behavior exactly for ASCII input and byte-level
for the greedy fallback (the C++ code operates on raw UTF-8 bytes).

Differences from the reference (improvements, flagged):

* ``max_len`` truncation — the reference never truncates to the model's 77
  context positions (admitted gap, upstream tests/README.md:16); we
  truncate by default while keeping the EOS token.
"""

from __future__ import annotations

import re
from typing import Sequence

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407

# GPT-2 style split pattern, ASCII classes to mirror std::regex [[:alpha:]] /
# [[:digit:]] with the default "C" locale (upstream clip.cpp:609).
_SPLIT_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+",
    re.ASCII,
)


class ClipTokenizer:
    """Greedy vocab-matching tokenizer over a GGUF token list.

    The vocabulary is the ``tokenizer.ggml.tokens`` string array of a CLIP
    GGUF checkpoint (written from HF ``vocab.json`` key order by the
    converter, see upstream models/convert_hf_to_gguf.py:85-87).
    """

    def __init__(self, tokens: Sequence[str], bos_id: int = BOS_TOKEN_ID, eos_id: int = EOS_TOKEN_ID):
        self.id_to_token = list(tokens)
        # Greedy matching works on the raw UTF-8 bytes like the C++ code.
        # Duplicate token strings: the LAST id wins, matching the reference's
        # std::map operator[] assignment loop (upstream clip.cpp:482).
        self.token_to_id: dict[bytes, int] = {}
        for i, tok in enumerate(self.id_to_token):
            self.token_to_id[tok.encode("utf-8")] = i
        self.bos_id = bos_id
        self.eos_id = eos_id

    @property
    def n_vocab(self) -> int:
        return len(self.id_to_token)

    def encode(self, text: str, max_len: int | None = 77) -> list[int]:
        """Tokenize ``text`` to ids, bracketed by BOS/EOS.

        ``max_len=None`` reproduces the reference's unbounded output.
        """
        ids = [self.bos_id]
        for word in _SPLIT_RE.findall(text):
            ids.extend(self._encode_word(word))
        if max_len is not None and len(ids) > max_len - 1:
            ids = ids[: max_len - 1]
        ids.append(self.eos_id)
        return ids

    def _encode_word(self, word: str) -> list[int]:
        # whole-word fast path: strip one leading space, append </w>
        stripped = word[1:] if word.startswith(" ") else word
        wid = self.token_to_id.get((stripped + "</w>").encode("utf-8"))
        if wid is not None:
            return [wid]

        # greedy longest-substring fallback over the raw word (leading space
        # kept, no </w>), byte-wise like the C++ std::string::substr loop
        out: list[int] = []
        data = word.encode("utf-8")
        i = 0
        n = len(data)
        while i < n:
            j = n
            while j > i:
                tid = self.token_to_id.get(data[i:j])
                if tid is not None:
                    out.append(tid)
                    i = j
                    break
                j -= 1
            else:
                # single byte unknown: skip it (reference prints a warning and
                # advances, upstream clip.cpp:663-666)
                i += 1
        return out

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        """Best-effort inverse (debugging aid; the reference has none)."""
        parts = []
        for i in ids:
            if skip_special and i in (self.bos_id, self.eos_id):
                continue
            parts.append(self.id_to_token[i])
        return "".join(parts).replace("</w>", " ").strip()

    def pad(self, ids: Sequence[int], length: int) -> tuple[list[int], int]:
        """Pad to a fixed length with EOS (safe filler: causal masking makes
        positions >= len(ids) invisible to the pooled EOT position).  Returns
        (padded_ids, true_length)."""
        ids = list(ids)
        if len(ids) > length:
            raise ValueError(f"sequence length {len(ids)} > padded length {length}")
        return ids + [self.eos_id] * (length - len(ids)), len(ids)
