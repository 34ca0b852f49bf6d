"""Hand-written CUDA kernels for attention and the SSD scan (``csrc/``), their
ctypes wrappers, the model-layout entry points (``ops``) and the plain
PyTorch versions (``ref``).  Nothing here needs ``nvcc`` at import: the
kernels build at their first launch (``build``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
