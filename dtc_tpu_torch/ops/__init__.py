"""Attention and head ops; the decode-attention kernel wrapper."""
