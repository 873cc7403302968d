"""The plain reference of the benchmark: float32 PyTorch, no kernels, no
import of the program."""
