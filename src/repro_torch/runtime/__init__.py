"""Serving runtime of the port: the shared TickLoop and the PyTorch backend."""
