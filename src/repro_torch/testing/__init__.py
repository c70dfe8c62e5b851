"""Multi-process harness and numeric checks of the port's DDP path."""
