"""Hand-written CUDA kernels of the port: build, binding and wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs the plain
PyTorch version beside it on a CPU tensor; kernels build at first use."""
