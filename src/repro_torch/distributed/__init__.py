"""Pipeline execution of the port (pp=1 so far)."""
