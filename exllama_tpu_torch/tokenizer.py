"""Tokenizers with the reference's batching semantics (port of
exllama_tpu/tokenizer.py; a copy, since the port imports nothing of the JAX
package).

  * batch encode left-pads with the pad id and returns a boolean mask, so
    the last token of every row sits at the generation point;
  * decode strips padding and stops at the first EOS;
  * single-sequence encode can splice literal special-token text;
  * ``newline_token_id = 13``.

``ExLlamaTokenizer`` wraps SentencePiece (imported when one is built);
``FakeTokenizer`` is a deterministic byte-level codec for the tests and
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Union

import numpy as np


class TokenizerBase:
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    newline_token_id: int = 13
    unk_token_id: int = 0

    def _encode_one(self, text: str) -> list[int]:
        raise NotImplementedError

    def _decode_ids(self, ids: list[int]) -> str:
        raise NotImplementedError

    def num_tokens(self, text: str) -> int:
        return len(self._encode_one(text))

    def encode(
        self,
        text: Union[str, list[str]],
        return_mask: bool = False,
        max_seq_len: int = 2048,
        add_bos: bool = False,
        add_eos: bool = False,
        encode_special_characters: bool = False,
    ):
        """str → [1, T] int32; list[str] → left-padded [B, T] (+ bool mask).

        Mirrors reference tokenizer.py:34-106 (mask True = real token).
        """
        if isinstance(text, list):
            rows = [self._encode_one(t) for t in text]
            rows = [r[: max_seq_len - add_bos - add_eos] for r in rows]
            if add_bos:
                rows = [[self.bos_token_id] + r for r in rows]
            if add_eos:
                rows = [r + [self.eos_token_id] for r in rows]
            max_len = max(len(r) for r in rows)
            ids = np.full((len(rows), max_len), self.pad_token_id, np.int32)
            mask = np.zeros((len(rows), max_len), bool)
            for i, r in enumerate(rows):
                if r:
                    ids[i, -len(r):] = r
                    mask[i, -len(r):] = True
            return (ids, mask) if return_mask else ids

        if encode_special_characters:
            row = self._encode_with_special(text)
        else:
            row = self._encode_one(text)
        row = row[: max_seq_len - add_bos - add_eos]
        if add_bos:
            row = [self.bos_token_id] + row
        if add_eos:
            row = row + [self.eos_token_id]
        ids = np.asarray([row], np.int32)
        if return_mask:
            return ids, np.ones_like(ids, bool)
        return ids

    def _encode_with_special(self, text: str) -> list[int]:
        """Splice literal special-token text (reference tokenizer.py:69-92):
        occurrences of "<s>"/"</s>" in the string become the bos/eos ids."""
        specials = [("</s>", self.eos_token_id), ("<s>", self.bos_token_id)]
        out: list[int] = []
        rest = text
        while rest:
            cut, lit, tok = len(rest), None, None
            for l, tid in specials:
                j = rest.find(l)
                if j != -1 and j < cut:
                    cut, lit, tok = j, l, tid
            if cut:
                out.extend(self._encode_one(rest[:cut]))
            if lit is None:
                break
            out.append(tok)
            rest = rest[cut + len(lit):]
        return out

    def decode(self, ids) -> Union[str, list[str]]:
        """[T] or [B, T] → str or list[str]; strips pad, stops at EOS
        (reference tokenizer.py:117-142)."""
        ids = np.asarray(ids)
        if ids.ndim == 1:
            row = [int(t) for t in ids if int(t) != self.pad_token_id]
            if self.eos_token_id in row:
                row = row[: row.index(self.eos_token_id)]
            return self._decode_ids(row)
        return [self.decode(r) for r in ids]


class ExLlamaTokenizer(TokenizerBase):
    """Llama tokenizer backed by a SentencePiece ``tokenizer.model``."""

    def __init__(self, tokenizer_model_path: str):
        import sentencepiece

        self.path = tokenizer_model_path
        self._sp = sentencepiece.SentencePieceProcessor(
            model_file=tokenizer_model_path
        )
        self.bos_token_id = self._sp.bos_id()
        self.eos_token_id = self._sp.eos_id()
        self.pad_token_id = 0
        self.unk_token_id = self._sp.unk_id()

    def _encode_one(self, text: str) -> list[int]:
        return list(self._sp.encode(text))

    def _decode_ids(self, ids: list[int]) -> str:
        return self._sp.decode(ids)


class FakeTokenizer(TokenizerBase):
    """Deterministic byte-level codec for tests (ids 4..259 = bytes 0..255)."""

    vocab_size = 260

    def _encode_one(self, text: str) -> list[int]:
        return [b + 4 for b in text.encode("utf-8")]

    def _decode_ids(self, ids: list[int]) -> str:
        data = bytes(t - 4 for t in ids if 4 <= t < 260)
        return data.decode("utf-8", errors="replace")
