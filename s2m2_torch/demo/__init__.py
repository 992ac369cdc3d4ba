"""Command-line demos of the port, run as `python -m s2m2_torch.demo.<name>`."""
