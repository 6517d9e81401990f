"""Hand-written CUDA kernels for Hopper and their wrappers.

Sources live in ``prompt_tts_tpu_torch/csrc/`` and are built at first use
(``_build.py``); each wrapper launches its kernel on a CUDA tensor and runs
its plain PyTorch version on a CPU tensor.
"""
