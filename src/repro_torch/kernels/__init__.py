"""The port's hand-written CUDA kernels, their plain PyTorch versions and
the dispatch around them. Nothing here builds at import: ``_build`` runs
``nvcc`` on the first launch."""
