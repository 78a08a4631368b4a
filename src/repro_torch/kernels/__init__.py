# Hand-written CUDA kernels of the port, one package per reference kernel
# (pext, bitonic, build, lookup, merge, dbit): ops.py holds the wrapper,
# its launch count and the plain-PyTorch version; ref.py an independent
# numpy oracle.
