"""gLLM reproduction on PyTorch and CUDA: the port of the JAX package
``repro`` to NVIDIA Hopper.

The package imports torch, numpy and the standard library only — nothing of
JAX and nothing of ``repro``; what it needs of the JAX package's
framework-free modules (configs, scheduler, Token Throttling, paged-KV
manager, tick loop) it keeps as its own copies.  Its module layout follows
``repro`` so each module's counterpart is found by name.
"""
