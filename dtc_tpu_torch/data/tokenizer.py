"""The tokenizer of ``dataset: fineweb``: the port's copy of the JAX
package's ``data/tokenizer.py``.

:func:`get_tokenizer` loads GPT-2's tokenizer with a ``<pad>`` token added
(vocab 50258) through ``transformers``, imported only when it is called,
from the local cache unless downloads are allowed. Where that fails it
raises, unless the caller opts into :class:`ByteTokenizer` (same vocab
size, other token semantics), which is then used with a warning.
"""

from __future__ import annotations

import os

#: GPT-2's vocab (50257) + the added ``<pad>`` token.
GPT2_PADDED_VOCAB = 50258


class ByteTokenizer:
    """UTF-8 bytes as tokens, the vocab padded to GPT-2's + ``<pad>``."""

    def __init__(self, vocab_size: int = GPT2_PADDED_VOCAB):
        self._vocab_size = vocab_size

    def __len__(self) -> int:
        return self._vocab_size

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def get_tokenizer(allow_download: bool | None = None,
                  allow_byte_fallback: bool | None = None):
    """GPT-2's tokenizer with ``<pad>`` (vocab 50258). Raises
    ``RuntimeError`` when it cannot be loaded, unless
    ``allow_byte_fallback`` (or ``DTC_ALLOW_BYTE_FALLBACK=1``) asks for
    :class:`ByteTokenizer`. ``allow_download`` (or ``DTC_ALLOW_DOWNLOAD=1``)
    lets ``transformers`` fetch it; by default only its cache is read."""
    if allow_download is None:
        allow_download = os.environ.get("DTC_ALLOW_DOWNLOAD", "0") == "1"
    if allow_byte_fallback is None:
        allow_byte_fallback = os.environ.get("DTC_ALLOW_BYTE_FALLBACK", "0") == "1"
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("gpt2", local_files_only=not allow_download)
        tok.add_special_tokens({"pad_token": "<pad>"})
        return tok
    except Exception as e:
        if not allow_byte_fallback:
            raise RuntimeError(
                "Could not load the GPT-2 tokenizer (offline cache miss or "
                f"download failure: {e!r}). Refusing to silently substitute a "
                "byte-level tokenizer — it changes training semantics. Set "
                "DTC_ALLOW_BYTE_FALLBACK=1 (or allow_byte_fallback=True) to "
                "opt into the ByteTokenizer fallback."
            ) from e
        print("WARNING: GPT-2 tokenizer unavailable; using byte-level fallback "
              "tokenizer (same vocab size, DIFFERENT token semantics).")
        return ByteTokenizer()
