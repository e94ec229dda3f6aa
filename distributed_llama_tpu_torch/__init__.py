"""distributed_llama_tpu_torch — the PyTorch/CUDA port of distributed_llama_tpu.

The same `.m` Q40 model files and `.t` tokenizers, the same module layout
(`formats/`, `models/`, `ops/`, `runtime/`, `cli.py`, `testing.py`), run in
PyTorch on an NVIDIA Hopper card. Each Pallas kernel of the JAX package
becomes a hand-written CUDA kernel under `csrc/`, built with nvcc at first use
and bound with ctypes (ops/kernels.py). Entry points run on the card unless
the caller asks for the CPU, where every kernel wrapper takes its plain
PyTorch version.

This package imports nothing from `distributed_llama_tpu` and never imports
jax: what it needs from the JAX package's host modules it keeps as copies.
"""

__version__ = "0.1.0"
