"""Llama-family model over a dict of tensors."""
