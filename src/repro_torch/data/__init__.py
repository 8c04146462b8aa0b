"""Data pipelines of the port (twin of `repro.data`)."""
