"""Hand-written CUDA kernels for Hopper (sources in `gpe_tpu_torch/csrc/`).

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version only for CPU tensors. Each keeps a launch counter
(`<wrapper>.launches`) that counts kernel launches and nothing else.
"""
