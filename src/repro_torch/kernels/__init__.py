"""Hand-written Hopper kernels of the port, one package each in the
ops/ref/impl idiom: ``ops.py`` dispatches (a CPU tensor to the plain
PyTorch version in ``ref.py``, a CUDA tensor to the kernel), and the impl
module wraps the CUDA C++ source in ``repro_torch/csrc/``."""
