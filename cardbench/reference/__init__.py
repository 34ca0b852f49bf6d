"""The plain reference: float32 PyTorch with TF32 off, written from the
published architectures as the configuration files state them.  It
imports nothing of the program and nothing of JAX, and takes from the
benchmark only the weights it draws from the seed and the tokens."""
