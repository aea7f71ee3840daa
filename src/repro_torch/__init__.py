"""PyTorch/CUDA port of the JAX model stack in ``repro``, for NVIDIA Hopper.

It mirrors the layout of ``repro`` (``models``, ``kernels``, ``runtime``,
``launch``) and imports nothing of it, nor JAX: what it needs of the
framework-free modules is copied here. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``. Every Pallas kernel on a ported path is
a hand-written CUDA kernel under ``kernels/csrc``.
"""
