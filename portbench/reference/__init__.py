"""The plain reference: the published decoder block in float32 PyTorch.

It imports nothing of the port and nothing of JAX. From the same seeded
bf16 weights that the program is given, it works the int4 codes and scales
out again (`quant.py`, a frozen copy of the arithmetic the program's set-up
applies), and runs the full causal forward over prompt + served tokens,
layer by layer, with TF32 off.
"""
