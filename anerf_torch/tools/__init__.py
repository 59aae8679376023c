"""Command-line tools of the port: `python -m anerf_torch.tools.<name>`."""
