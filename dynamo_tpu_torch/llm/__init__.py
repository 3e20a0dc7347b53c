"""Token-level request/response protocols, tokenizers and the OpenAI
serving stages."""

from .tokenizer import BaseTokenizer, ByteTokenizer, DecodeStream, HFTokenizer

__all__ = ["BaseTokenizer", "ByteTokenizer", "DecodeStream", "HFTokenizer"]
