"""Attention, rope and sampling ops; kernels under ../csrc."""
