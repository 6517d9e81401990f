"""prompt_tts_tpu_torch: the PyTorch/CUDA port of prompt_tts_tpu.

A second package beside the JAX one, which stays the reference: each
module keeps the file name of its JAX counterpart.  It imports torch and
never jax; of the JAX package it uses only the pure-Python host modules
(``config``, ``frontend``, ``utils.wav``).  The two TPU kernels on the
synthesis path are hand-written CUDA kernels for Hopper (``csrc/``).
"""
