"""Device operations of the port: kernel wrappers and the merge bridge."""
