"""adlm_tpu_torch — the PyTorch/CUDA port of ``adlm_tpu``.

A second package beside the JAX one, with the same module names, so
each counterpart is easy to find.  It imports ``torch`` and numpy and
nothing of JAX or of ``adlm_tpu``.  Plain tensor code is PyTorch; the
two kernels the JAX package wrote in Pallas for the TPU are CUDA C++
for Hopper (``csrc/``), built with ``nvcc`` at first use.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where the plain PyTorch versions of the kernels run.
"""

__version__ = "0.1.0"
