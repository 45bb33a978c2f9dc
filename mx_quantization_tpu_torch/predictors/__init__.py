"""Predictors of the port: ELSA's structured projection (the exponent
family runs inside kernels K3 and K4)."""
