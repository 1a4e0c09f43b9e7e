"""PyTorch/CUDA port of the BatchWeave model and serving layers.

A second package beside ``repro`` (the JAX reference). It imports ``torch``
and numpy only — never ``jax`` and never a ``repro`` module; the few jax-free
pieces it needs (stats windows, the metrics registry) are its own copies.
Module names mirror ``repro`` so each counterpart is easy to find.

Entry points (``init_params``, ``init_decode_state``, ``ServeEngine``) run
on the CUDA card unless the caller passes ``device="cpu"``; the train step
(``repro_torch.train``) runs where the parameters and batch lie. On a CUDA
tensor every kernel wrapper launches its hand-written Hopper kernel
(``csrc/``) or raises; on a CPU tensor it runs the kernel's plain PyTorch
version.
"""
