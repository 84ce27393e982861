"""Foundation utilities carried over from the JAX package."""
