"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources live in `locus_tpu_torch/csrc/`; `build.py` compiles
them at first use."""
