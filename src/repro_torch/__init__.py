"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100 (sm_90a).

The package mirrors ``src/repro/``'s module names. It imports ``torch`` and
numpy only — never ``jax`` and nothing of the ``repro`` package — and keeps
the reference's public layouts (NCHW / chw activations, ``(K, C, f, f)``
weights). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel's wrapper takes the
kernel's plain PyTorch version.

Scope so far: profile primitives and tile columns on the card
(``service.platforms.GpuPlatform``), train the performance models there or
transfer a simulated platform's onto it (``pretrain``, ``calibrate``:
factor, finetune, scratch), select a CNN's primitives
(``service.pipeline.optimise``: the models on the device, PBQP on the
host), lower the assignment, compile it into a batched plan and serve it.
Every Pallas kernel of the reference is ported to hand-written CUDA in
``csrc/``.
"""
