"""Array operations of the port: color, resampling, padding, patching,
clamp-casts, the Gram/eigh SVD, the BCD solver and its CUDA kernel."""
