"""Plain PyTorch references of models the port runs and the JAX package does not
have, independent of both packages."""
