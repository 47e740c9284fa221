"""The plain reference: PyTorch and NumPy only.

Imports nothing of the program (``sylber_tpu_torch``) and nothing of JAX.
It takes the weights and the inputs the benchmark made, never anything the
program derived from them.
"""
