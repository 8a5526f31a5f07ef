"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (the CPU path and the card's parity target)."""
