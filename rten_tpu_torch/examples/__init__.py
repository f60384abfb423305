"""Example applications on the port, run as ``python -m
rten_tpu_torch.examples.<name>``: copies of the JAX package's
``examples/`` apps that run on the card (``--cpu``: on the host, through
the kernels' plain versions). Importing an app runs nothing."""
