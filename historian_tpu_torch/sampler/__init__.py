"""Host samplers of the port: the refiner and the simulator."""
