"""Device operations of the port: each a plain PyTorch version plus the
wrapper of its CUDA kernel (csrc/)."""
