"""Engine layer of the port: the merge fill hook and the likelihood rescore."""
