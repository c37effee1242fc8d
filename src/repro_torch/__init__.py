"""PyTorch/CUDA port of the GraphGen+ repro (``src/repro`` is the JAX
reference it is held to).

The package mirrors ``repro``'s layout module for module.  It imports
torch and numpy only — never jax, never ``repro`` — and its entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  The hot spots
that ``repro`` writes as Pallas kernels are CUDA C++ kernels here
(``kernels/csrc``), each with a plain-torch twin in ``kernels/ref.py``
that CPU tensors dispatch to.
"""
