"""The port's kernels: one hand-written CUDA kernel per Pallas kernel of the
reference (``csrc/*.cu``), each behind an ``ops.py`` wrapper that launches
it for CUDA tensors and runs the plain PyTorch version in ``ref.py`` for
CPU tensors.  Kernels are compiled at first use (``kernels.build``)."""
