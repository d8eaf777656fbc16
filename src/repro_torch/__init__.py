"""PyTorch + CUDA port of ``repro`` for an NVIDIA H100 (sm_90a).

The package mirrors ``src/repro/``'s module names. It imports ``torch`` and
numpy only — never ``jax`` and nothing of the ``repro`` package — and keeps
the reference's public layouts (NCHW / chw activations, ``(K, C, f, f)``
weights). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every hand-written kernel's wrapper takes the
kernel's plain PyTorch version.

Scope so far: lower an assigned CNN, compile it
into a batched plan and serve it, with the three Pallas kernels on that
path (``matmul``, ``conv_im2col_batch``, ``winograd_point_gemm_batch``)
ported to hand-written CUDA in ``csrc/``.
"""
