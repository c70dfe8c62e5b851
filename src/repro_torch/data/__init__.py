"""Synthetic data (numpy only) — a copy of the JAX package's generator,
so both packages draw the same prompts from one seed."""
from repro_torch.data.synthetic import SyntheticLM, batch_for_model

__all__ = ["SyntheticLM", "batch_for_model"]
