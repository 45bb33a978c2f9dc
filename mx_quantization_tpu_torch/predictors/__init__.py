"""Q·K^T predictors: the exponent family and ELSA (kernels K2, K3, K4 and
K7 compute the same operands inside their tiles)."""
