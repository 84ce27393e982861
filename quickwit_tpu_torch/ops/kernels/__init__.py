"""Hand-written GPU kernels, each with its plain torch version."""
