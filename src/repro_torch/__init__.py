"""PyTorch/CUDA port of the `repro` BoW image-classification stack.

The package mirrors `repro`'s layout (`core`, `kernels`, `kernels/stencil`,
`cv`, `data`) so each module's counterpart is easy to find.  Every kernel
that `repro` writes in Pallas for the TPU is a CUDA C++ kernel here, under
`csrc/`, built for `sm_90a` at first use (`kernels._build`).  Beside each
kernel sits a plain PyTorch version of the same arithmetic: a wrapper takes
it for a tensor that lies on the CPU, and launches the kernel (or raises)
for a CUDA tensor.

Public entry points take ``device=None``, which means ``"cuda"``; with no
CUDA device they raise `RuntimeError` instead of running on the CPU.  Pass
``device="cpu"`` to run the plain versions.
"""
