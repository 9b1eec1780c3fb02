"""PyTorch/CUDA port of the networked federated learning solver.

The counterpart of the JAX/Pallas package ``repro``, with the same
subpackage and function names (``core``, ``data``, ``engine``, ``api``,
``kernels``, ``scenarios``) so that each part can be found beside its
reference.  It imports ``torch`` and ``numpy`` and nothing of ``jax`` or
``repro``.  Entry points take ``device=None``, which means the CUDA card
(:mod:`repro_torch.device`).  Each of the reference's TPU kernels —
``fused_pd_step``, ``tv_prox`` and ``batched_affine`` — is a
hand-written CUDA kernel for Hopper (``csrc/``) with a plain PyTorch
version beside it (``kernels/ref.py``).  :mod:`repro_torch.interop`
builds the port's objects from numpy arrays.
"""
