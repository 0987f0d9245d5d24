"""Device ops of the port: histogram kernels and their plain versions,
split search, traversal."""
