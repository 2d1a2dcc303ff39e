"""Hand-written Hopper kernels (``csrc/``), their host wrappers, their
plain PyTorch versions (``ref``) and the dispatch layer (``ops``)."""
