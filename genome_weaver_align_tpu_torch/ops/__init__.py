"""Device ops: window gather, banded DP (plain torch and CUDA), host affine."""
