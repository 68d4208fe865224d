"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package reimplements
its serving main path (dense GQA and MLA decoders, the VLM and
encoder-decoder frontends, pure-SSM Mamba-2 and the zamba2 hybrid,
chunked streamed prefill, per-slot decode, paged KV block pool for the
dense GQA and VLM families), training on one device
(``runtime/trainer.py``; dense, Mamba-2 and the hybrid) and dense
tensor-parallel over rank processes, and the PGAS substrate, with plain
PyTorch tensor code and hand-written CUDA kernels for ``sm_90a`` in place
of the Pallas TPU kernels (flash attention, the SSD chunked scan, the DLA
matmul, the collective matmuls).

The package imports ``torch`` and never ``jax`` or anything of ``repro``.
Entry points (``models.model.init_params``, ``runtime.server.Server``,
``runtime.trainer.Trainer``, ``launch/serve.py``, ``launch/train.py``) run
on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU they
raise instead of falling back.
"""
