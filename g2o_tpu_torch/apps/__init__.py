"""Command-line applications (port of the JAX package's ``apps``)."""
