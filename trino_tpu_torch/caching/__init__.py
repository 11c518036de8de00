"""caching layer of the torch port (see module docstrings)."""
