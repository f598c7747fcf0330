"""dct_tpu_torch: the PyTorch + CUDA port of dct_tpu, for an NVIDIA H100.

Same subpackage layout and module names as ``dct_tpu`` (the JAX reference,
which this package never imports). Entry points run on ``cuda:0`` unless
the caller passes ``device="cpu"``; kernels are hand-written CUDA C++ for
``sm_90a`` under ``ops/csrc/``, built at first use.
"""
