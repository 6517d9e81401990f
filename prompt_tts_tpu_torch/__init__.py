"""prompt_tts_tpu_torch: the PyTorch/CUDA port of prompt_tts_tpu.

A second package beside the JAX one, which stays the reference: each
module keeps the file name of its JAX counterpart.  It imports torch and
never jax, and nothing of the JAX package: it keeps its own copies of the
host modules it needs (``config``, ``frontend``, ``utils.wav``,
``utils.resample``).  The four TPU kernels on the synthesis, training and
encode paths (attention forward and backward, the codec LSTM, the
residual-VQ encode) are hand-written CUDA kernels for Hopper (``csrc/``).
"""
