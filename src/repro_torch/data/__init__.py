"""Synthetic data (numpy only) — a copy of the JAX package's generator,
so both packages draw the same prompts from one seed — and the
prefetching loader over it."""
from repro_torch.data.loader import PrefetchLoader, make_synthetic_loader
from repro_torch.data.synthetic import SyntheticLM, batch_for_model

__all__ = ["SyntheticLM", "batch_for_model", "PrefetchLoader",
           "make_synthetic_loader"]
