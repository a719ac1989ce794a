"""The eager Paddle surface of the port: dtypes, Tensor and autograd,
the random generators and parameter attributes."""
