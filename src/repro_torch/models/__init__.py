"""Model code of the port: layers, the dense transformer, the serve tick
blocks, the dense reference and the JAX-parameter bridge."""
