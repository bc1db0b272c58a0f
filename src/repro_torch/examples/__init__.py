"""The reference's four examples on the port: ``python -m repro_torch.examples.<name>``."""
