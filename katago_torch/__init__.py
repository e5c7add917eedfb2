"""katago_torch — the PyTorch/CUDA port of katago_tpu.

Same layout as the JAX package (game/, ops/, models/, search/, selfplay/,
dataio/, cli/, utils/); the two hand-written CUDA kernels of the selfplay
search path live under ops/csrc/. The package imports torch and numpy
only — never jax, flax or katago_tpu — and its entry points run on CUDA
unless the caller passes device="cpu".
"""
