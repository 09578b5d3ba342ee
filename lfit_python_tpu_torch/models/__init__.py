"""Parameter tree, priors, CV forward model and posterior."""
