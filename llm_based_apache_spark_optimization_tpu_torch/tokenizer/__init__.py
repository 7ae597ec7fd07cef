"""Tokenizers: the protocol and the byte-level tokenizer."""

from .base import Tokenizer  # noqa: F401
from .byte import ByteTokenizer  # noqa: F401
