"""The port's kernels: CUDA for Hopper, each with a plain PyTorch version
(``ref``) and one dispatching entry point (``ops``)."""
