"""Host utilities of the port: logging, memory size, the mt19937 generator."""
