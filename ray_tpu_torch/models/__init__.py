"""Models of the port: PyTorch nn.Modules held to the JAX package's models."""
