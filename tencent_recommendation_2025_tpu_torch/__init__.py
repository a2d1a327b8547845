"""PyTorch/CUDA port of ``tencent_recommendation_2025_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

Same module names as the JAX package, so each module's counterpart is found
by path. Plain tensor code is PyTorch; each Pallas kernel of the JAX package
becomes a kernel written by hand for Hopper under ``csrc/``, bound with
``ctypes`` (``ops/kernels.py``) and held against a plain PyTorch version of
the same function. Entry points run on the card unless the caller asks for
the CPU.

- ``data``      — copies of the JAX package's numpy data layer
- ``models``    — fusion towers, HSTU encoder, ``SeqRecModel`` (inference)
- ``ops``       — the fused HSTU block kernel wrapper and the kernel builder
- ``retrieval`` — exact top-k MIPS, HR/NDCG, the ANN file contract
- ``train``     — checkpoint reading and writing
- ``cli``       — the ``infer`` entry point with the reference's env-var contract
- ``bridge``    — parameters from the JAX package
"""

__version__ = "0.1.0"
