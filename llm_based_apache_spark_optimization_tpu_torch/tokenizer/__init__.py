"""Tokenizers: the protocol, the byte-level tokenizer, trainable byte-level
BPE and the HF tokenizer.json adapter."""

from .base import Tokenizer  # noqa: F401
from .bpe import BPETokenizer, train_bpe  # noqa: F401
from .byte import ByteTokenizer  # noqa: F401
from .hf import HFTokenizer  # noqa: F401
