"""PyTorch/CUDA port of the dynamo_tpu serving engine.

The JAX package (``dynamo_tpu``) is the reference; this package imports
none of it.  Device code runs on an NVIDIA GPU through hand-written Hopper
kernels (``csrc/``); every entry point runs on the card unless the caller
passes ``device="cpu"`` (device.py).
"""
