from .pipeline import chain_halo  # noqa: F401

__all__ = ["chain_halo"]
