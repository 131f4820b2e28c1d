"""Host samplers of the port: the refiner, the simulator, and MCMC (the
sampler and its sibling matrix)."""
