"""Example service graphs on the port (the JAX package's ``examples/``)."""
