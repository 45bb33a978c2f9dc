"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version and a launch counter on its wrapper."""
